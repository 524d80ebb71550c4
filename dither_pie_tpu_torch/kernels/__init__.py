"""Hand-written Hopper (sm_90a) CUDA kernels of the port and their loader.

``csrc/`` holds the sources: ``skew.cu`` (K1), ``ed_scan.cu`` (K2),
``unskew_unpack.cu`` (K3) and the PyTorch binding ``bindings.cpp``.
``build.extension()`` compiles them at first use. The Python wrappers that
launch them, count their launches and hold their plain PyTorch versions
live in ``dither_pie_tpu_torch/ops/wavefront.py``.
"""
