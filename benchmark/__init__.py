"""The benchmark of ria_tpu_torch on NVIDIA H100 cards: one cell, one run.

Run from the root of a checkout: ``python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``.  See ``harness.py``.
"""
