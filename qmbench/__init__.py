"""The benchmark of quickmer2_tpu_torch's count on one NVIDIA H100.

run.py drives one run of one cell; BENCHMARK.json at the checkout's root
names the cells and metrics, and each configuration, traffic mix and
per-layer metric is a file of its own here, found by its name.
"""
