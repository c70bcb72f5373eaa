#!/usr/bin/env python3
"""The port's H100 benchmark: one run of one cell.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each compared number
beside its limit, also the last lines of standard error). The metrics are
the cell's end-to-end metrics, and with ``--trace 1`` its per-layer
metrics besides (read from a profiled stretch after the window). Exits non-zero
without a result when the cell's CUDA devices are missing. See
``h100_bench/README.md``.
"""

import os
import sys
import time

T_START = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# The byte code of every module imported from here on (PyTorch's too) is
# cached at a fixed path in the checkout, even where the environment turns
# byte-code writing off, so that only a checkout's first run compiles it.
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(BENCH_DIR, "_cache", "pycache")
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from h100_bench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
