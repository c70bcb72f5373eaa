#!/usr/bin/env python3
"""node-large-train's check taken apart: the routes and the reference's own gaps.

    python3 scripts/torch_node_check_gaps.py [--seeds 12] [--first-seed N]
        [--extra-seed S ...] [--refs 2] [--nodes N --avg-deg D] [--device cuda]
        [--out FILE]

For each seed (``h100_bench/control.py``'s seeds, then each ``--extra-seed``)
it builds the cell's training object from the seed as the benchmark does
(``h100_bench/traffic/train_steps.py``) and runs its checked steps twice,
on the same inputs, weights and dropout draws: on the MMA layer's own
route (kernels 2-3 with the keep) and on the half-fused route (the layer
handed the graph without its CSC view). The two recordings of the draws
must be equal. Then it runs the benchmark's plain reference ``--refs``
times, and twice more under ``torch.use_deterministic_algorithms``, on
the draws of the first route, and prints the benchmark's compared
numbers (``train_steps.compare``: ``loss_gap``, ``grad_gap``,
``update_gap``) for:

- each route against reference run 1;
- each later reference run against reference run 1;
- the second deterministic reference run against the first, and the
  program's route against the first;

and, element by element, each leaf's largest difference in the
parameters' change over the checked steps over that leaf's largest
change: the half-fused route against the lean one, reference run 2
against run 1. One JSON line a seed, then for each pair the largest
reading over the seeds and the number of seeds whose ``update_gap``
reached a tenth of its limit. ``CUBLAS_WORKSPACE_CONFIG`` is set to
``:4096:8`` (the deterministic runs need it). ``--nodes`` and
``--avg-deg`` shrink the graph for a run on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100_bench import core  # noqa: E402
from h100_bench.draws import Recorder  # noqa: E402

CELL = "node-large-train"


@contextlib.contextmanager
def half_fused():
    """The MMA layer's aggregate on the graph without its CSC view, which
    takes the half-fused route; every other op of the step as it is."""
    from mma_tpu_torch.nn import mma_layer

    real = mma_layer.masked_multi_aggregate

    def without_csc(h, graph, *args, **kwargs):
        return real(h, dataclasses.replace(graph, src_perm=None), *args, **kwargs)

    mma_layer.masked_multi_aggregate = without_csc
    try:
        yield
    finally:
        mma_layer.masked_multi_aggregate = real


def checked_steps(cell, seed: int, device: str, route: str):
    """The checked steps of one training object on ``route``: what
    ``train_steps.run`` records for the check, and the reference's inputs."""
    from mma_tpu_torch.ops.cuda import fused_mma

    program = cell.program()
    obj = program.Train(cell.config, seed, device)
    before = fused_mma.LAUNCHES["edge_program_lean_keep"]
    with program.precision(cell.config), \
            (half_fused() if route == "half_fused" else contextlib.nullcontext()):
        p0 = obj.params()
        losses, draws = [], []
        for i in range(int(cell.params["check_steps"])):
            with Recorder() as rec:
                losses.append(float(obj.step()))
            draws.append(rec.draws)
            if i == 0:
                grad1 = {k: v.clone() for k, v in obj.first_gradient().items()}
        rec = {"losses": losses, "grad1": grad1, "params0": p0, "params": obj.params()}
    keep_calls = fused_mma.LAUNCHES["edge_program_lean_keep"] - before
    if torch.device(device).type == "cuda" and (keep_calls > 0) != (route == "lean_keep"):
        raise AssertionError(f"route {route}: {keep_calls} calls of kernel 2 with the keep")
    inputs = dict(obj.reference_inputs(), draws=draws)
    obj.free()
    return rec, inputs


def reference_run(cell, inputs, p0, deterministic: bool):
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        ref = cell.reference().train_steps(inputs, p0, cell.config,
                                           int(cell.params["check_steps"]))
    finally:
        torch.use_deterministic_algorithms(before)
    return {"losses": ref["losses"], "grad1": ref["grad1"], "params0": p0,
            "params": ref["params"]}


def elementwise_update_gap(a, b) -> float:
    """The worst leaf's largest |Δa - Δb| over its largest |Δb|, Δ the
    parameters' change over the checked steps."""
    worst = 0.0
    for k, p0 in b["params0"].items():
        db = b["params"][k] - p0
        da = a["params"][k].to(db.device) - p0
        scale = float(db.abs().max())
        if scale > 0:
            worst = max(worst, float((da - db).abs().max()) / scale)
    return worst


def one_seed(cell, seed: int, device: str, refs: int) -> dict:
    compare = core.load_module("traffic", cell.traffic).compare
    runs = {route: checked_steps(cell, seed, device, route)
            for route in ("lean_keep", "half_fused")}
    (lean, inputs), (fused, fused_inputs) = runs["lean_keep"], runs["half_fused"]
    for a, b in zip(inputs["draws"], fused_inputs["draws"]):
        if len(a) != len(b) or not all(x[0] == y[0] and torch.equal(x[1], y[1])
                                       for x, y in zip(a, b)):
            raise AssertionError(f"seed {seed}: the two routes drew differently")
    del fused_inputs
    p0 = lean["params0"]
    ref = [reference_run(cell, inputs, p0, False) for _ in range(refs)]
    det = [reference_run(cell, inputs, p0, True) for _ in range(2)]
    pairs = {"lean_keep vs ref 1": compare(lean, ref[0]),
             "half_fused vs ref 1": compare(fused, ref[0])}
    for i in range(1, refs):
        pairs[f"ref {i + 1} vs ref 1"] = compare(ref[i], ref[0])
    pairs["det ref 2 vs det ref 1"] = compare(det[1], det[0])
    pairs["lean_keep vs det ref 1"] = compare(lean, det[0])
    elem = {"half_fused vs lean_keep": elementwise_update_gap(fused, lean)}
    if refs > 1:
        elem["ref 2 vs ref 1"] = elementwise_update_gap(ref[1], ref[0])
    return {"seed": seed, "checks": pairs, "elementwise_update_gap": elem}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--extra-seed", type=int, action="append", default=[])
    ap.add_argument("--refs", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--avg-deg", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    core.set_cache_dirs()
    over = {k: v for k, v in (("num_nodes", args.nodes), ("avg_deg", args.avg_deg))
            if v is not None}
    cell = core.find_cell(CELL, {"config": over})
    if torch.device(args.device).type == "cuda":
        from mma_tpu_torch.ops.cuda import build

        build.build_all()
        print(core.smi_line(), flush=True)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)] + args.extra_seed
    limits = cell.limits
    lines = []
    for seed in seeds:
        line = one_seed(cell, seed, args.device, args.refs)
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {}
    for pair in lines[0]["checks"]:
        readings = [ln["checks"][pair] for ln in lines]
        summary[pair] = {name: max(r[name] for r in readings) for name in limits}
        summary[pair]["seeds_update_gap_over_a_tenth_of_its_limit"] = sum(
            r["update_gap"] >= 0.1 * limits["update_gap"] for r in readings)
    for pair in lines[0]["elementwise_update_gap"]:
        summary[f"elementwise {pair}"] = max(ln["elementwise_update_gap"][pair] for ln in lines)
    print("summary", json.dumps({"seeds": len(lines), "limits": limits, **summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": lines, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
