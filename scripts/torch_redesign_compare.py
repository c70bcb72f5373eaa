#!/usr/bin/env python3
"""Time kernels 6 and 12 of this checkout beside another checkout's, in turns.

    python3 scripts/torch_redesign_compare.py OTHER_ROOT [--prog-settings 40,32,48]
        [--masked-settings 4:2,4:4,...] [--out FILE]

Needs an NVIDIA GPU and ``nvcc``. Builds ``OTHER_ROOT``'s
``mma_tpu_torch/csrc/segment_minmax.cu`` and ``fused_mma.cu`` with the
port's ``nvcc`` flags (``mma_tpu_torch/ops/cuda/build.py``), this
checkout's ``segment_minmax.cu`` once more for each stage budget in KB of
``--prog-settings`` (``-DMMA_PROG_SMEM_KB``) and its
``fused_mma.cu`` for each ``MIN_BLOCKS:EDGES`` pair of
``--masked-settings`` (``-DMMA_MASKED_MIN_BLOCKS``, ``-DMMA_MASKED_EDGES``),
all at once, into ``artifacts/redesign_compare/``. ``OTHER_ROOT`` is a
checkout with the row-per-thread kernel 6 and the warp-per-row kernel 12,
whose C entries are

    mma_minmax_prog(c, hg, row_ptr, seed, out, n_rows, n_chan, n_ops, max_bits,
                    thresh, scale, bf16, stream)
    mma_masked_segment_sum(logits, h_src, pat, row_ptr, out, n_rows, f, kf, vec4,
                           logits_bf16, h_bf16, stream)

for example a ``git archive`` of the parent commit unpacked under the
git-ignored ``artifacts/``. Then, on the same tensors:

- kernel 6 at the ZINC flagship batch (the first 1,024 synthetic ZINC train
  molecules, 46,858 edges, N = 23,552, C = 375, random normal ``c`` and
  ``hg`` from a seed) in float32 and bf16, ``min,max`` with the hash
  dropout at 0.5, and the ``scatter_reduce_`` amax plus amin of the
  pre-built message; this checkout's kernel at each stage budget;
- kernel 12 at synthetic-large (131,072 nodes, ``avg_deg=16``, seed 1;
  K·F = 128, F = 64, random normal logits and ``h_src``) in float32 and
  bf16, the whole call and its heaviest row alone, and this checkout's
  kernel at each launch setting.

Each pair is timed in turns (other, this, this, other), each turn the
median of 25 back-to-back calls by CUDA events. Before timing, this
checkout's kernel 6 must equal the other's bit for bit (f32 and bf16, one
and two ops, dropout on and off) and its plain version; kernel 12 must lie
within 1e-5 of the largest value of the other's and of the plain
version's, and every setting's within 1e-5 of the default's. Prints one
line per measurement and writes them all to ``--out`` (by default
``artifacts/redesign_compare/redesign_compare.json``) as JSON, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from mma_tpu_torch.ops.cuda import build, fused_mma  # noqa: E402
from mma_tpu_torch.ops.cuda import segment_minmax as mm  # noqa: E402

OUT_DIR = os.path.join(ROOT, "artifacts", "redesign_compare")
CSRC = os.path.join("mma_tpu_torch", "csrc")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def device_ms(fn, iters: int = 25) -> float:
    """Median device time of one call over ``iters`` back-to-back calls
    (CUDA events; a spin kernel holds the stream while the host enqueues)."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(iters))


def turns(other, this) -> tuple:
    """``(this_ms, other_ms)``: medians of turns other, this, this, other."""
    t = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        t[which].append(device_ms(other if which == "other" else this))
    return statistics.median(t["this"]), statistics.median(t["other"])


def build_libs(other_root: str, prog_settings, settings) -> dict:
    """Compile every library at once; ``{tag: ctypes.CDLL}``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {
        "other_segment_minmax": (os.path.join(other_root, CSRC, "segment_minmax.cu"), []),
        "other_fused_mma": (os.path.join(other_root, CSRC, "fused_mma.cu"), []),
    }
    for kb in prog_settings:
        jobs[f"prog_{kb}"] = (os.path.join(ROOT, CSRC, "segment_minmax.cu"),
                              [f"-DMMA_PROG_SMEM_KB={kb}"])
    for blocks, edges in settings:
        jobs[f"masked_{blocks}_{edges}"] = (
            os.path.join(ROOT, CSRC, "fused_mma.cu"),
            [f"-DMMA_MASKED_MIN_BLOCKS={blocks}", f"-DMMA_MASKED_EDGES={edges}"])
    procs = {}
    for tag, (src, defines) in jobs.items():
        out = os.path.join(OUT_DIR, f"lib{tag}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", out, src]
        procs[tag] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        if tag.startswith(("masked_", "prog_")):  # the kernel's registers and spills
            mine = False
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    mine = ("masked_edge_kernel" if tag.startswith("masked_")
                            else "minmax_prog_kernel") in line
                elif mine and ("registers" in line or "spill" in line):
                    print(f"{tag}: {line.strip()}")
        libs[tag] = ctypes.CDLL(out)
    return libs


def _check(lib, err, what):
    if err != 0:
        lib.mma_cuda_error_string.restype = ctypes.c_char_p
        lib.mma_cuda_error_string.argtypes = [_I]
        raise RuntimeError(f"{what}: {lib.mma_cuda_error_string(err).decode()}")


def other_minmax_prog(lib):
    fn = lib.mma_minmax_prog
    fn.argtypes = [_P] * 5 + [_I] * 5 + [_F, _I, _P]
    fn.restype = _I

    def run(c, hg, rp, ops, seed, rate):
        thresh, scale = mm._dropout_params(rate) if seed is not None else (0, 1.0)
        out = torch.empty((c.shape[0], len(ops) * c.shape[1]), device=c.device)
        err = fn(c.data_ptr(), hg.data_ptr(), rp.data_ptr(),
                 None if seed is None else seed.data_ptr(), out.data_ptr(), c.shape[0],
                 c.shape[1], len(ops), mm._max_bits(ops), thresh, scale, mm._bf16(hg),
                 torch.cuda.current_stream().cuda_stream)
        _check(lib, err, "other minmax_prog")
        return out
    return run


def other_masked(lib):
    fn = lib.mma_masked_segment_sum
    fn.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    fn.restype = _I

    def run(logits, h_src, pat, rp):
        n, f, kf = rp.shape[0] - 1, h_src.shape[1], logits.shape[1]
        out = torch.empty((n, kf), device=logits.device)
        err = fn(logits.data_ptr(), h_src.data_ptr(), pat.data_ptr(), rp.data_ptr(),
                 out.data_ptr(), n, f, kf, int(f % 4 == 0), fused_mma._bf16(logits),
                 fused_mma._bf16(h_src), torch.cuda.current_stream().cuda_stream)
        _check(lib, err, "other masked_segment_sum")
        return out
    return run


def setting_prog(lib):
    """This checkout's kernel 6 from a library built at another setting."""
    fn = lib.mma_minmax_prog
    fn.argtypes = [_P] * 5 + [_I, ctypes.c_int64] + [_I] * 4 + [_F, _I, _P]
    fn.restype = _I

    def run(c, hg, rp, ops, seed, rate):
        thresh, scale = mm._dropout_params(rate) if seed is not None else (0, 1.0)
        out = torch.empty((c.shape[0], len(ops) * c.shape[1]), device=c.device)
        err = fn(c.data_ptr(), hg.data_ptr(), rp.data_ptr(),
                 None if seed is None else seed.data_ptr(), out.data_ptr(), c.shape[0],
                 hg.shape[0], c.shape[1], len(ops), mm._max_bits(ops), thresh, scale,
                 mm._bf16(hg), torch.cuda.current_stream().cuda_stream)
        _check(lib, err, "minmax_prog setting")
        return out
    return run


def setting_masked(lib):
    """This checkout's kernel 12 from a library built at another setting."""
    fn = lib.mma_masked_segment_sum
    fn.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    fn.restype = _I
    lib.mma_segment_sum_n_chunks.argtypes = [_I]
    lib.mma_segment_sum_n_chunks.restype = _I

    def run(logits, h_src, pat, rp):
        n, f, kf, e = rp.shape[0] - 1, h_src.shape[1], logits.shape[1], logits.shape[0]
        dev = logits.device
        out = torch.empty((n, kf), device=dev)
        n_chunks = lib.mma_segment_sum_n_chunks(e)
        part = torch.empty((n_chunks, 2, kf), device=dev)
        tail = torch.empty((n_chunks,), dtype=torch.int32, device=dev)
        err = fn(logits.data_ptr(), h_src.data_ptr(), pat.data_ptr(), rp.data_ptr(),
                 out.data_ptr(), part.data_ptr(), tail.data_ptr(), n, f, kf, e,
                 int(f % 4 == 0), fused_mma._bf16(logits), fused_mma._bf16(h_src),
                 torch.cuda.current_stream().cuda_stream)
        _check(lib, err, "masked_segment_sum setting")
        return out
    return run


def close(got, want, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{what}: max_abs_err {err:.3e} > 1e-5 of {scale:.3e}")
    return err


def zinc_inputs(dev):
    from mma_tpu_torch.data import load_zinc

    ds = load_zinc("train", subset_size=1024)
    n_need = int(ds.num_nodes.sum()) + 1
    e_need = int(sum(len(s_) for s_ in ds.edge_src))
    batch = next(ds.batches(1024, n_node=-(-n_need // 1024) * 1024,
                            n_edge=-(-e_need // 1024) * 1024, device=dev))
    g = batch.graph
    gen = torch.Generator(device=dev).manual_seed(0)
    c = torch.randn(g.n_node, 375, generator=gen, device=dev)
    hg = torch.randn(g.n_edge, 375, generator=gen, device=dev)
    return g, c, hg


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--prog-settings", default="40,32,48")
    ap.add_argument("--masked-settings", default="4:2,4:4,4:1,3:2")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "redesign_compare.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_redesign_compare: no CUDA device", file=sys.stderr)
        return 1
    settings = [tuple(int(v) for v in s.split(":")) for s in args.masked_settings.split(",")]
    prog_settings = [int(v) for v in args.prog_settings.split(",")]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    build.build_all()
    libs = build_libs(os.path.abspath(args.other_root), prog_settings, settings)
    rows = []

    def record(what, this_ms, other_ms, **extra):
        rows.append({"what": what, "ms": this_ms, "other_ms": other_ms, **extra})
        other = "" if other_ms is None else f", other {other_ms:.4f} ms"
        print(f"{what}: this {this_ms:.4f} ms{other} "
              + " ".join(f"{k} {v}" for k, v in extra.items()))

    with torch.no_grad():
        # Kernel 6 at the ZINC flagship batch.
        g, c32, hg32 = zinc_inputs(dev)
        rp = g.real_row_ptr
        e_cov, n_rows, ch = int(rp[-1]), g.n_node, c32.shape[1]
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        prog = other_minmax_prog(libs["other_segment_minmax"])
        progs = {kb: setting_prog(libs[f"prog_{kb}"]) for kb in prog_settings}
        ids = fused_mma._row_ids(rp)[:, None].expand(e_cov, ch)
        for dt in (torch.float32, torch.bfloat16):
            c, hg = c32.to(dt), hg32.to(dt)
            for ops in (("min", "max"), ("max",)):
                for sd in (seed, None):
                    got = mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5)
                    what = f"minmax_prog {dt} ops={ops} dropout={sd is not None}"
                    for want, who in ((prog(c, hg, rp, ops, sd, 0.5), "other"),
                                      (mm.minmax_edge_program_reference(c, hg, rp, ops, sd, 0.5),
                                       "plain"),
                                      (mm.minmax_edge_program(c, hg, rp, ops, sd, 0.5), "again")):
                        if not torch.equal(got, want):
                            raise AssertionError(f"{what}: differs from {who}")
            ops = ("min", "max")
            msg = mm._messages(c, hg, rp, seed, 0.5)[0]

            def library():
                return [torch.zeros(n_rows, ch, device=dev).scatter_reduce_(
                    0, ids, msg, "amax" if op == "max" else "amin", include_self=False)
                    for op in ops]

            this_ms, other_ms = turns(lambda: prog(c, hg, rp, ops, seed, 0.5),
                                      lambda: mm.minmax_edge_program(c, hg, rp, ops, seed, 0.5))
            esz = c.element_size()
            nbytes = esz * (e_cov * ch + n_rows * ch) + 4 * ((n_rows + 1) + 1 + n_rows * 2 * ch)
            record(f"minmax_prog {str(dt)[6:]}", this_ms, other_ms,
                   bound_ms=nbytes / 3.35e12 * 1e3, library_ms=device_ms(library),
                   shape=f"E={e_cov} N={n_rows} C={ch} min,max dropout 0.5")
            want = mm.minmax_edge_program(c, hg, rp, ops, seed, 0.5)
            for s_, run in progs.items():
                if not torch.equal(run(c, hg, rp, ops, seed, 0.5), want):
                    raise AssertionError(f"minmax_prog {dt} setting {s_} differs")
            times = {s_: [] for s_ in prog_settings}
            for order in (prog_settings, prog_settings[::-1]):
                for s_ in order:
                    times[s_].append(device_ms(lambda: progs[s_](c, hg, rp, ops, seed, 0.5)))
            for s_ in prog_settings:
                record(f"minmax_prog {str(dt)[6:]} MMA_PROG_SMEM_KB={s_}",
                       statistics.median(times[s_]), None)
        print("minmax_prog: equal to the other checkout's and to plain, f32 and bf16, "
              "one and two ops, dropout on and off")
        del c32, hg32, c, hg, msg

        # Kernel 12 at synthetic-large.
        from mma_tpu_torch.data.synthetic import synthetic_powerlaw

        big = synthetic_powerlaw(131072, avg_deg=16, seed=1, device=dev)
        rp = big.real_row_ptr
        e, n = big.n_edge, big.n_node
        e_cov = int(rp[-1])
        f, kf = 64, 128
        gen = torch.Generator(device=dev).manual_seed(1)
        l32 = torch.randn(e, kf, generator=gen, device=dev)
        h32 = torch.randn(e, f, generator=gen, device=dev)
        pat = ((torch.arange(kf, device=dev) // f) % 2 == 0).float()
        deg = rp[1:] - rp[:-1]
        top = int(torch.argmax(deg))
        one_row = rp[top:top + 2].contiguous()
        masked = other_masked(libs["other_fused_mma"])
        runs = {s: setting_masked(libs[f"masked_{s[0]}_{s[1]}"]) for s in settings}
        for dt in (torch.float32, torch.bfloat16):
            lg, hs = l32.to(dt), h32.to(dt)
            name = f"masked_segment_sum {str(dt)[6:]}"
            got = fused_mma.masked_segment_sum(lg, hs, pat, rp)
            if not torch.equal(got, fused_mma.masked_segment_sum(lg, hs, pat, rp)):
                raise AssertionError(f"{name} differs run to run")
            err_other = close(got, masked(lg, hs, pat, rp), f"{name} vs other")
            err_plain = close(got, fused_mma.masked_segment_sum_reference(lg, hs, pat, rp),
                              f"{name} vs plain")
            this_ms, other_ms = turns(lambda: masked(lg, hs, pat, rp),
                                      lambda: fused_mma.masked_segment_sum(lg, hs, pat, rp))
            nbytes = lg.element_size() * e_cov * (kf + f) + 4 * (kf + (n + 1) + n * kf)
            record(name, this_ms, other_ms, bound_ms=nbytes / 3.35e12 * 1e3,
                   max_abs_err_vs_other=err_other, max_abs_err_vs_plain=err_plain,
                   shape=f"E={e_cov} N={n} F={f} K·F={kf}")
            close(fused_mma.masked_segment_sum(lg, hs, pat, one_row),
                  fused_mma.masked_segment_sum_reference(lg, hs, pat, one_row),
                  f"{name} heaviest row vs plain")
            this_ms, other_ms = turns(lambda: masked(lg, hs, pat, one_row),
                                      lambda: fused_mma.masked_segment_sum(lg, hs, pat, one_row))
            record(f"{name} heaviest row alone ({int(deg[top])} edges)", this_ms, other_ms)
            for s, run in runs.items():
                close(run(lg, hs, pat, rp), got, f"{name} setting {s}")
            times = {s: [] for s in settings}
            for order in (settings, settings[::-1]):
                for s in order:
                    times[s].append(device_ms(lambda: runs[s](lg, hs, pat, rp)))
            for s in settings:
                record(f"{name} MMA_MASKED_MIN_BLOCKS={s[0]} MMA_MASKED_EDGES={s[1]}",
                       statistics.median(times[s]), None)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f_:
        json.dump({"device": smi, "rows": rows}, f_, indent=1)
    print(json.dumps({"ok": True, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
