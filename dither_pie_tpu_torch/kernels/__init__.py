"""Hand-written Hopper (sm_90a) CUDA kernels of the port and their loader.

``csrc/`` holds the sources: ``skew.cu`` (K1), ``ed_scan.cu`` (K2),
``unskew_unpack.cu`` (K3), ``ordered.cu`` (K4) and the PyTorch binding
``bindings.cpp``. ``build.extension()`` compiles them at first use and
``build.LAUNCHES`` counts their launches. The Python wrappers that launch
them and hold their plain PyTorch versions live in
``dither_pie_tpu_torch/ops/wavefront.py`` (K1-K3) and
``dither_pie_tpu_torch/ops/ordered_fused.py`` (K4).
"""
