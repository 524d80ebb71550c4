"""Hand-written Hopper (sm_90a) CUDA kernels of the port and their loader.

``csrc/`` holds the sources: ``skew.cu`` (K1, K6 and K7, one tile
transpose over C = 3 or 1 channels, u8 or f32 in, u8 or f32 out),
``ed_scan.cu`` (K2 and K8, with the score branch), ``unskew_unpack.cu``
(K3, K5 and K9, one tile transpose by output kind), ``ordered.cu`` (K4),
``search_probe.cu``, ``gather_probe.cu`` and
``identity.cu`` (the probes T2, T1, T3), ``riemersma_scan.cu`` (R1, the
Riemersma scan, which replaces a ``lax.scan`` and no Pallas kernel) and
the PyTorch binding ``bindings.cpp``;
``tile_copy.cuh`` holds the 16-byte word moves that the tile transposes
share, ``palette_search.cuh`` the palette search that K2/K8 and T2 share.
``build.extension()`` compiles them at first use and ``build.LAUNCHES``
counts their launches. The Python wrappers that launch them and hold their
plain PyTorch versions live in
``dither_pie_tpu_torch/ops/wavefront.py`` (K1-K3, K5-K9),
``dither_pie_tpu_torch/ops/ordered_fused.py`` (K4),
``dither_pie_tpu_torch/ops/riemersma_scan.py`` (R1),
``dither_pie_tpu_torch/tools/proto_mxu_search.py`` (T2),
``dither_pie_tpu_torch/tools/gather_probe.py`` (T1) and
``dither_pie_tpu_torch/tools/layout_repro.py`` (T3).
"""
