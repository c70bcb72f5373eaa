#!/usr/bin/env python3
"""Split kernel 6's time (``minmax_prog``) into its phases on the card.

    python3 scripts/torch_minmax_prog_phases.py

Needs an NVIDIA GPU and ``nvcc``. Builds three patched copies of
``mma_tpu_torch/csrc/segment_minmax.cu`` beside the unpatched one into
``artifacts/minmax_prog_phases/`` (the port's ``nvcc`` flags), each missing
one phase of the kernel, and times all four at the ZINC flagship batch
(the first 1,024 synthetic ZINC train molecules, C = 375, ``min,max``,
hash dropout at 0.5; random normal ``c`` and ``hg`` from a seed) in float32
and bf16, in two rounds:

- ``tile search only``: each block finds its tile's rows and leaves;
- ``staging only``: the tile's copies into shared memory, no reduction and
  no stores;
- ``no stores``: everything but the stores of ``out``;
- ``whole``: the kernel as built for the port.

Beside them, the card's own rates on the same tensors: a ``fill_`` of an
``out``-sized tensor (70.6 MB written), a copy of ``hg`` and a sum over
``hg`` and ``c``. Prints one line each, with the card's name and power
limit. The patched copies compute nothing usable; only their times mean
anything.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import torch_redesign_compare as compare  # noqa: E402
from mma_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = os.path.join(ROOT, "mma_tpu_torch", "csrc", "segment_minmax.cu")
OUT_DIR = os.path.join(ROOT, "artifacts", "minmax_prog_phases")

# Each patch: (text of the kernel, its replacement); the text must occur once.
SEARCH_DONE = "  const ProgTile t = tile_s;\n  if (t.rows == 0) return;  // the whole block leaves\n"
STAGED = "  __syncthreads();  // the tile is in the stage\n"
STORES = "        o[0] = b0;\n        if (P == 2) o[n_chan] = b1;\n"
PATCHES = {
    "tile search only": (SEARCH_DONE, SEARCH_DONE + "  if (t.rows > 0) return;\n"),
    "staging only": (STAGED, STAGED + "  if (t.rows > 0) return;\n"),
    "no stores": (STORES, "        if (b0 == 1234.5f && b1 == 5432.1f) o[0] = b0;\n"),
    "whole": None,
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_minmax_prog_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    src = open(SOURCE).read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, patch in PATCHES.items():
        text = src
        if patch is not None:
            if src.count(patch[0]) != 1:
                raise RuntimeError(f"{name}: the patched text is not in the source once")
            text = src.replace(patch[0], patch[1])
        tag = name.replace(" ", "_")
        path = os.path.join(OUT_DIR, f"{tag}.cu")
        with open(path, "w") as f:
            f.write(text)
        out = os.path.join(OUT_DIR, f"lib{tag}.so")
        procs[name] = (out, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", out, path],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    runs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        runs[name] = compare.setting_prog(ctypes.CDLL(out))

    dev = torch.device("cuda")
    g, c32, hg32 = compare.zinc_inputs(dev)
    rp = g.real_row_ptr
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    ops = ("min", "max")
    out = torch.empty(g.n_node, 2 * c32.shape[1], device=dev)
    for dt in (torch.float32, torch.bfloat16):
        c, hg = c32.to(dt), hg32.to(dt)
        hg2 = torch.empty_like(hg)
        times = {}
        for _ in range(2):
            for name, run in runs.items():
                times.setdefault(name, []).append(
                    compare.device_ms(lambda: run(c, hg, rp, ops, seed, 0.5)))
            times.setdefault("fill_ of out (70.6 MB written)", []).append(
                compare.device_ms(lambda: out.fill_(1.0)))
            times.setdefault("copy of hg (read and written)", []).append(
                compare.device_ms(lambda: hg2.copy_(hg)))
            times.setdefault("sum over hg and c (read)", []).append(
                compare.device_ms(lambda: (hg.sum(0), c.sum(0))))
        for name, t in times.items():
            print(f"minmax_prog {str(dt)[6:]} {name}: {statistics.median(t):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
