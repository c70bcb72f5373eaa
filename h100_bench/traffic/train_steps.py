"""Traffic kind ``train_steps``: training steps back to back, one object.

Set-up builds the configuration's training object (``configs/<config>.py``
``Train``: model, optimizer state, inputs) and drives it from the seed
through its first ``check_steps`` steps by the same call as the window,
recording what the check needs: the losses, the first gradient as the
optimizer took it, the parameters before and after, and the random draws
of each step (``h100_bench/draws.py``), from which the reference reads
the program's dropout keeps. The window then
steps the same object for ``--seconds``. With ``--trace 1`` a profiled
stretch of ``trace_steps`` steps follows the window. Once the peak
memory is read and the program's state is freed, the reference
(``reference/<config>.py``) repeats the first steps from the same
weights and inputs, and the gaps are compared (see :func:`compare`).

Parameters (the workload file's ``params``): ``check_steps``,
``trace_steps``.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import torch

from h100_bench import trace as T
from h100_bench.core import Outcome, device_kind
from h100_bench.draws import Recorder


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    ref_norms = {k: _norm(ref[k]) for k in names}
    median = statistics.median(ref_norms.values())
    worst = 0.0
    for k in names:
        scale = max(ref_norms[k], median)
        gap = abs(_norm(prog[k].to(ref[k].device)) - ref_norms[k]) / scale if scale > 0 else 0.0
        worst = max(worst, gap)
    return worst


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of a training check.

    ``loss_gap``: the worst step's |loss - reference loss| / |reference
    loss|. ``grad_gap``: :func:`leaf_gap` of the first gradient.
    ``update_gap``: :func:`leaf_gap` of the parameters' change over the
    checked steps, leaving out the leaves whose reference gradient is under
    a thousandth of the median leaf's (they move by round-off alone)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_norms = {k: _norm(v) for k, v in ref["grad1"].items()}
    g_median = statistics.median(g_norms.values())
    moving = {k for k, v in g_norms.items() if v >= 1e-3 * g_median}
    p0 = prog["params0"]
    d_prog = {k: prog["params"][k] - p0[k] for k in p0}
    d_ref = {k: ref["params"][k] - p0[k].to(ref["params"][k].device) for k in p0}
    return {"loss_gap": loss_gap, "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "update_gap": leaf_gap(d_prog, d_ref, moving)}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    cfg, params = cell.config, cell.params
    check_steps = int(params["check_steps"])
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    program = cell.program()
    obj = program.Train(cfg, seed, device)
    t_built = time.perf_counter()
    with program.precision(cfg):
        p0 = obj.params()
        losses, draws = [], []
        for i in range(check_steps):
            with Recorder() as rec:
                loss = obj.step()
            losses.append(float(loss))
            draws.append(rec.draws)
            if i == 0:
                grad1 = {k: v.clone() for k, v in obj.first_gradient().items()}
        checked = {"losses": losses, "grad1": grad1, "params0": p0, "params": obj.params()}
        _sync(device)
        setup_s = time.perf_counter() - t_start
        print(f"set-up {setup_s:.3f} s: to the built object {t_built - t_start:.3f} s, "
              f"{check_steps} first steps {time.perf_counter() - t_built:.3f} s", flush=True)

        host = []
        steps = 0
        gc.collect()
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            obj.step()
            host.append(time.perf_counter() - a)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0

        reduced = None
        if trace:
            reduced = _profile(obj, int(params["trace_steps"]), device)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    work = obj.work()
    visits = obj.edge_visits_per_step
    inputs = dict(obj.reference_inputs(), draws=draws)
    obj.free()
    del obj
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.reference().train_steps(inputs, p0, cfg, check_steps)
    checks = compare(checked, ref)
    layer = {"step_host_ms": 1e3 * statistics.fmean(host), "units": steps, "window_s": window_s,
             "work": work, "device_kind": device_kind(device)}
    metrics = {"setup_s": setup_s, "train_edges_per_s": steps * visits / window_s}
    return Outcome(attempted=steps, failed=0, metrics=metrics, checks=checks,
                   memory_peak_bytes=int(peak), layer=layer, trace=reduced)


def _profile(obj, n_steps: int, device):
    """``n_steps`` steps under the profiler, inside the benchmark's spans."""
    spans = T.ModuleSpans(obj.layers)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with T.span("window"):
                for _ in range(n_steps):
                    with T.span("step"):
                        obj.step()
                _sync(device)
    finally:
        spans.remove()
    return T.reduce_profile(prof, n_steps, module_spans=tuple(obj.layers))
