"""The benchmark of the PyTorch and CUDA port (`uzu_tpu_torch`).

`run.py` is the one command. Everything that belongs to one model
configuration, traffic mix, per-layer metric or kernel group sits in files
of its own, found by the name that `BENCHMARK.json` gives (see README).
This package imports nothing at import time, so the plain reference
(`reference/`) can be imported without the port.
"""
