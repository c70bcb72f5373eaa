#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, in one process.

    python3 h100_bench/control.py --workload <cell> --seeds 12 --control-seeds 3
        [--seconds 1] [--out FILE]

For each of ``--seeds`` seeds it runs the cell as the benchmark does
(set-up, a window of ``--seconds``, the check) and records the compared
numbers: the lower readings. For ``--control-seeds`` seeds it runs the
same with the timed path changed:

- ``tf32``: the configuration's float32 products in TF32, the nearest
  precision below the configuration's (float32 with TF32 off): the
  control that has to come out not correct;
- ``bf16``: the port's ``compute_dtype="bfloat16"`` edge pipeline, read
  beside it;
- the faults the cell can have, which its configuration's program lists
  (``configs/<config>.py``: ``FAULTS``) and plants in its timed call
  (``plant``): here ``half_batch`` (a training step that takes the loss
  over half its training nodes), ``unchanged`` (a step that leaves the
  state as it was), ``altered_answer`` (a served answer changed where it
  is made).

It prints one JSON line per run and a summary (the largest sound reading
and the smallest reading of each variant, per number). The benchmark's
own runs never run it. ``tests/test_bench_control.py`` runs it small on
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import core  # noqa: E402


@contextlib.contextmanager
def planted(cell: str, fault):
    """Plant ``fault`` in the timed call of ``cell``'s program for the block:
    each configuration's program lists its faults (``FAULTS``) and plants
    them (``plant``)."""
    if fault is None:
        yield
        return
    with core.find_cell(cell).program().plant(fault):
        yield


PRECISIONS = {
    "sound": {},
    "tf32": {"matmul_precision": "high"},
    "bf16": {"compute_dtype": "bfloat16"},
}


def one(cell: str, variant: str, seed: int, seconds: float, device: str, overrides=None):
    cfg_over, fault = (PRECISIONS[variant], None) if variant in PRECISIONS else ({}, variant)
    over = {"config": dict((overrides or {}).get("config", {}), **cfg_over),
            "params": (overrides or {}).get("params", {})}
    t0 = time.perf_counter()
    with planted(cell, fault):
        r, _ = core.run_cell(cell, seed, seconds, False, device, t0, over)
    return {"variant": variant, "seed": seed, "correct": r["correct"],
            "checks": {k: v["value"] for k, v in r["checks"].items()},
            "limits": {k: v["limit"] for k, v in r["checks"].items()},
            "wall_s": time.perf_counter() - t0}


def readings(cell: str, seeds, control_seeds, seconds: float, device: str = "cuda",
             overrides=None, variants=None, log=print):
    variants = variants or ("tf32", "bf16") + tuple(core.find_cell(cell).program().FAULTS)
    runs = [one(cell, "sound", s, seconds, device, overrides) for s in seeds]
    for r in runs:
        log(json.dumps(r))
    for v in variants:
        for s in control_seeds:
            r = one(cell, v, s, seconds, device, overrides)
            log(json.dumps(r))
            runs.append(r)
    summary = {}
    for r in runs:
        for name, value in r["checks"].items():
            key = (r["variant"], name)
            pick = max if r["variant"] == "sound" else min
            summary[key] = value if key not in summary else pick(summary[key], value)
    return runs, {f"{v}.{n}": x for (v, n), x in sorted(summary.items())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--variants", default=None, help="comma-separated; default: all the cell's")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    core.set_cache_dirs()
    print(core.smi_line(), flush=True)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    control = [args.first_seed + 104729 + 7919 * i for i in range(args.control_seeds)]
    variants = tuple(args.variants.split(",")) if args.variants else None
    runs, summary = readings(args.workload, seeds, control, args.seconds, variants=variants,
                             log=lambda s: print(s, flush=True))
    print("summary", json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
