"""The harness core: finds a cell's files by name, runs its traffic, prints
the result line.

Nothing here knows a configuration, a traffic kind or a metric. A cell
``<name>`` is ``workloads/<name>.json``; it names a configuration
(``configs/<config>.json`` with its program side ``configs/<config>.py``
and its plain reference ``reference/<config>.py``) and a traffic kind
(``traffic/<kind>.py``). The per-layer metrics are ``metrics/<metric>.py``,
one reader each, listed in ``BENCHMARK.json``. Adding any of them is adding
files.

A traffic kind's ``run(cell, seed, seconds, trace, device, t_start)``
returns an :class:`Outcome`; this module adds the device, applies the
metric readers, decides ``correct`` from the checks and prints.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "mma_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.

    The port builds its kernels into ``mma_tpu_torch/_build/`` (fixed in
    its code); the rest goes under ``h100_bench/_cache/``."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold ``-`` and ``.``)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    tag = hashlib.sha256(BENCH_DIR.encode()).hexdigest()[:8]
    mod_name = f"h100_bench_{tag}_{kind}_{name}".replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload file with its configuration file, by name."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]

    @property
    def traffic(self) -> str:
        return self.workload["traffic"]

    @property
    def params(self) -> Dict[str, Any]:
        return self.workload.get("params", {})

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    def program(self):
        return load_module("configs", self.workload["config"])

    def reference(self):
        return load_module("reference", self.workload["config"])


def find_cell(name: str, overrides: Optional[Dict[str, Dict]] = None) -> Cell:
    """Cell ``name`` from its files. ``overrides`` (``{"config": {...},
    "params": {...}}``) replaces entries, for runs at other sizes than the
    benchmark's (the tests' CPU runs)."""
    workload = load_json("workloads", f"{name}.json")
    config = load_json("configs", f"{workload['config']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    workload["params"] = dict(workload.get("params", {}), **overrides.get("params", {}))
    return Cell(name, workload, config)


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def sub_seeds(seed: int, count: int) -> List[int]:
    """``count`` 31-bit seeds derived from any whole ``seed`` (negative or
    past 64 bits too), one per random stream of a run."""
    digest = hashlib.sha256(str(int(seed)).encode()).digest()
    return [int.from_bytes(digest[4 * i:4 * i + 4], "little") & 0x7FFFFFFF for i in range(count)]


def source_digest(*dirs: str) -> str:
    """A hash of every ``.py``, ``.cu``, ``.cpp`` and ``.json`` file under
    ``dirs`` (relative to the repository root), for cache keys."""
    h = hashlib.sha256()
    for d in dirs:
        top = os.path.join(ROOT, d)
        for base, subdirs, files in sorted(os.walk(top)):
            subdirs[:] = sorted(s for s in subdirs if not s.startswith(("_", ".")))
            for fn in sorted(files):
                if fn.endswith((".py", ".cu", ".cpp", ".json")):
                    p = os.path.join(base, fn)
                    h.update(os.path.relpath(p, ROOT).encode())
                    with open(p, "rb") as f:
                        h.update(f.read())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Outcome:
    """What a traffic kind's run returns.

    ``metrics``: the end-to-end metrics it took (name → value).
    ``checks``: the compared numbers (name → value), held to the cell's
    ``limits``. ``layer``: what the per-layer readers read (host times,
    counts, work, and with ``--trace 1`` the reduced trace).
    """

    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: Dict[str, float]
    memory_peak_bytes: int
    layer: Dict[str, Any]
    trace: Optional[Any] = None  # trace.Reduced, with --trace 1


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    table = load_json("peaks.json")
    return table.get(kind)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number present, finite and within its limit."""
    for name, limit in limits.items():
        v = checks.get(name)
        if v is None or not math.isfinite(v) or v > limit:
            return False
    return True


def read_layer_metrics(cell: Cell, outcome: Outcome) -> Dict[str, Dict]:
    """Apply every per-layer reader of ``BENCHMARK.json`` that names this
    cell (or names no cells); a reader that finds nothing returns None."""
    out = {}
    ctx = dict(outcome.layer, trace=outcome.trace, peaks=peaks_for(outcome.layer["device_kind"]),
               config=cell.config)
    for m in benchmark_spec()["per_layer"]:
        if not applies(m, cell.name):
            continue
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, overrides: Optional[Dict[str, Dict]] = None):
    """One run of cell ``name`` on ``device``. Returns ``(result, outcome)``:
    the result line's ``correct``, ``attempted``, ``failed``, ``metrics``,
    with a trace its ``breakdown``, and ``checks`` (each compared number
    beside its limit); and the traffic kind's :class:`Outcome`.
    ``t_start`` is when set-up began (the process's start)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(name, overrides)
    traffic = load_module("traffic", cell.traffic)
    outcome: Outcome = traffic.run(cell, seed, seconds, trace, device, t_start)
    correct = judge(outcome.checks, cell.limits) and outcome.failed == 0
    metrics = {m["name"]: {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
               for m in benchmark_spec()["end_to_end"]
               if applies(m, cell.name) and m["name"] in outcome.metrics}
    if trace:
        metrics.update(read_layer_metrics(cell, outcome))
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics}
    if outcome.trace is not None:
        result["breakdown"] = outcome.trace.breakdown()
    result["checks"] = {k: {"value": outcome.checks.get(k), "limit": v}
                        for k, v in cell.limits.items()}
    return result, outcome


def device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    import argparse

    ap = argparse.ArgumentParser(description="The port's H100 benchmark: one run of one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()

    import torch

    torch.set_num_threads(2)  # one process, few threads: steadier host times
    cell = find_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, outcome = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                               t_start)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    if outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
    checks = result.pop("checks")
    line = dict(result, device=device)
    if "breakdown" in line:
        line["breakdown"] = line.pop("breakdown")
    line["checks"] = checks
    print(smi_line(), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
