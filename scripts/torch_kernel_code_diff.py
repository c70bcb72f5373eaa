#!/usr/bin/env python3
"""Compare the machine code of ``csrc/fused_mma.cu`` in this checkout with another's.

    python3 scripts/torch_kernel_code_diff.py OTHER_ROOT [--match REGEX]

Builds ``mma_tpu_torch/csrc/fused_mma.cu`` of this checkout and of the
checkout at ``OTHER_ROOT`` with the port's own ``nvcc`` flags
(``mma_tpu_torch/ops/cuda/build.py``) into ``artifacts/code_diff/``, and
for every kernel of the other build whose name matches ``--match``
(default: every kernel) prints its registers and spill bytes (``-Xptxas
-v``) and the kernel of this build with the same SASS
(``cuobjdump -sass``, addresses and encodings dropped), with its registers
and spills, or ``no kernel with the same code``. Template arguments may
differ between the two builds, so kernels are matched by their code, not
their names. Ends with ``same code: N of M``. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mma_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = os.path.join("mma_tpu_torch", "csrc", "fused_mma.cu")
DEFAULT_MATCH = r"."  # every kernel


def compile_one(root: str, out: str) -> dict:
    """Build ``root``'s source into ``out``: ``{mangled: (regs, spill_st, spill_ld)}``."""
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out,
                          os.path.join(root, SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True).stdout
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage[name] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def sass_hashes(lib: str) -> dict:
    """``{mangled: digest}`` of each kernel's instructions, without
    addresses, encodings or its own name."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name, body = {}, None, []
    for line in text.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()
            name, body = m.group(1), []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and name is not None:
            body.append(m.group(1))
    out.pop("<end>", None)
    return out


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--match", default=DEFAULT_MATCH)
    args = ap.parse_args()
    outdir = os.path.join(ROOT, "artifacts", "code_diff")
    os.makedirs(outdir, exist_ok=True)
    libs = {w: os.path.join(outdir, f"{w}.so") for w in ("other", "this")}
    usage = {w: compile_one(r, libs[w]) for w, r in (("other", args.other_root), ("this", ROOT))}
    hashes = {w: sass_hashes(libs[w]) for w in libs}
    names = demangle(sorted(set(hashes["other"]) | set(hashes["this"])))
    by_hash = {}
    for n, h in hashes["this"].items():
        by_hash.setdefault(h, []).append(n)
    same = total = 0
    for n, h in sorted(hashes["other"].items(), key=lambda kv: names[kv[0]]):
        if not re.search(args.match, names[n]):
            continue
        total += 1
        regs = usage["other"].get(n)
        twins = by_hash.get(h, [])
        print(f"{names[n]}: registers {regs[0]}, spill stores {regs[1]} B, spill loads "
              f"{regs[2]} B" if regs else names[n])
        if twins:
            same += 1
            for t in twins:
                r = usage["this"].get(t)
                print(f"    same code: {names[t]}: registers {r[0]}, spill stores {r[1]} B, "
                      f"spill loads {r[2]} B" if r else f"    same code: {names[t]}")
        else:
            print("    no kernel with the same code")
    print(f"same code: {same} of {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
