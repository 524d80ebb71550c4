"""The pipelines above the facade: config-driven images (``image.py``) and
streaming video (``video.py``, with ffmpeg I/O in ``ffio.py`` and segmented
resume in ``resume.py``)."""
