"""The benchmark of dither_pie_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything that belongs to one
configuration, one traffic mix or one per-layer metric lives in a file of
its own (``configs/``, ``traffic/``, ``metrics/``), found by the name that
``BENCHMARK.json`` gives it.
"""
