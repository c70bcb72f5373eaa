"""Traffic kind ``serve_closed_loop``: one client sends a request, waits for
its answer on the host, and sends the next.

Set-up builds the configuration's serving object (``configs/<config>.py``
``Serve``: the served callable, its weights and a pool of distinct
requests collated on the host) and serves ``warm`` requests. The window
cycles through the pool in the seed's order for ``--seconds``, with the
objects of set-up frozen out of the garbage collector's generations
(``gc.freeze``, as a long-running server does once it is warm), so that a
collection in the window scans only what the window made; each
request is copied to the card, served, and its answers are copied back.
A request's latency runs from its send to its answers on the host; the
last request sent inside the window is waited for and counted. With
``--trace 1`` a profiled stretch of ``trace_requests`` requests follows.
Once the peak memory is read and the program's state is freed, the
reference (``reference/<config>.py``) predicts every pool request that
was answered, and every answer of the window is compared with it (see
:func:`compare`).

Parameters: ``min_molecules``, ``max_molecules``, ``pool``, ``warm``,
``trace_requests``.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from h100_bench import trace as T
from h100_bench.core import Outcome, device_kind


def compare(answers: List[Tuple[int, np.ndarray]], ref: Dict[int, np.ndarray]) -> Dict[str, float]:
    """``pred_gap``: the widest |answer - reference| over every answer of the
    window, over the root mean square of the reference's answers."""
    rms = float(np.sqrt(np.mean(np.concatenate(list(ref.values())).astype(np.float64) ** 2)))
    worst = 0.0
    for idx, got in answers:
        want = ref[idx]
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            return {"pred_gap": float("inf")}
        worst = max(worst, float(np.max(np.abs(got.astype(np.float64) - want))))
    return {"pred_gap": worst / rms}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    cfg, params = cell.config, cell.params
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    program = cell.program()
    obj = program.Serve(cfg, params, seed, device)
    t_built = time.perf_counter()
    order = np.arange(len(obj.pool))  # the pool is in the seed's order already

    def answer(req):
        return obj.receive(obj.call(obj.send(req)), req)

    with program.precision(cfg), torch.no_grad():
        for i in range(int(params["warm"])):
            answer(obj.pool[order[i % len(order)]])
        setup_s = time.perf_counter() - t_start
        print(f"set-up {setup_s:.3f} s: to the built object {t_built - t_start:.3f} s, "
              f"{params['warm']} warm requests {time.perf_counter() - t_built:.3f} s", flush=True)

        lat, call_host, answers = [], [], []
        k = 0
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            idx = int(order[k % len(order)])
            req = obj.pool[idx]
            k += 1
            ts = time.perf_counter()
            batch = obj.send(req)
            tc = time.perf_counter()
            out = obj.call(batch)
            tr = time.perf_counter()
            got = obj.receive(out, req)
            td = time.perf_counter()
            lat.append(td - ts)
            call_host.append(tr - tc)
            answers.append((idx, got))
        window_s = time.perf_counter() - t0

        reduced = None
        if trace:
            reduced = _profile(obj, order, int(params["trace_requests"]), device)
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    visits = sum(program.edge_visits(cfg, obj.pool[idx]) for idx, _ in answers)
    flops = sum(obj.work(obj.pool[idx])["flops"] for idx, _ in answers)
    answered = sorted({idx for idx, _ in answers})
    pool_ids = [obj.pool[i].ids for i in answered]
    traced_work = _traced_work(obj, order, int(params["trace_requests"])) if trace else None
    inputs = obj.reference_inputs()
    obj.free()
    del obj
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_by_pos = cell.reference().predict(inputs, cfg, pool_ids)
    ref = {answered[pos]: v for pos, v in ref_by_pos.items()}
    checks = compare(answers, ref)
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if len(lat) > 1 else lat[0]
    layer = {"served_call_host_ms": 1e3 * statistics.fmean(call_host), "units": len(lat),
             "window_s": window_s, "flops_total": flops, "traced_work": traced_work,
             "device_kind": device_kind(device)}
    metrics = {"setup_s": setup_s, "serve_p95_ms": 1e3 * p95,
               "serve_edges_per_s": visits / window_s}
    return Outcome(attempted=len(lat), failed=0, metrics=metrics, checks=checks,
                   memory_peak_bytes=int(peak), layer=layer, trace=reduced)


def _traced_work(obj, order, n: int) -> Dict[str, float]:
    """The summed work of the ``n`` requests that :func:`_profile` serves."""
    tot = {"flops": 0.0, "bytes": 0.0}
    for i in range(n):
        w = obj.work(obj.pool[order[i % len(order)]])
        tot["flops"] += w["flops"]
        tot["bytes"] += w["bytes"]
    return tot


def _profile(obj, order, n: int, device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with T.span("window"):
            for i in range(n):
                req = obj.pool[order[i % len(order)]]
                with T.span("request"):
                    with T.span("copy_in"):
                        batch = obj.send(req)
                    with T.span("served_call"):
                        out = obj.call(batch)
                    with T.span("copy_out"):
                        obj.receive(out, req)
    return T.reduce_profile(prof, n)
