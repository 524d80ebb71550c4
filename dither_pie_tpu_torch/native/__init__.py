"""The host engine: ``ed_scan.cpp``, the sequential error-diffusion scans
that have no wavefront (serpentine rows and the Riemersma Hilbert curve),
compiled with g++ at first use (``build.get_lib``)."""
