"""ZINC graph-regression CLI — the flags of the JAX package's
``mma_tpu.cli.train_zinc`` (flag-compatible with the reference
``graph_regression/mma.py:22-36``), plus ``--device``.

The run goes on the GPU unless ``--device cpu`` is given (the kernels'
plain PyTorch versions). ``--use-pallas`` is accepted and does nothing:
the device decides. ``--max-degree-hint`` is accepted and does nothing
(the kernels need no scan bound). ``--edge-format ell``, ``--remat``,
``--compute-dtype bfloat16|auto`` and ``--checkpoint-dir`` are not ported
yet and raise.

Usage (reproduces README.md:79):
    python -m mma_tpu_torch.cli.train_zinc --aggregators min,max \\
        --scalers identity,amplification,linear --weight_decay 3e-4 \\
        --lr 0.0001 --epochs 10000
"""

from __future__ import annotations

import argparse

from mma_tpu_torch.train import ZincConfig, train_zinc


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--hidden_dim", type=int, default=75)
    p.add_argument("--edge_dim", type=int, default=50)
    p.add_argument("--tower", type=int, default=5)
    p.add_argument("--L", type=int, default=4, help="number of conv layers")
    p.add_argument("--aggregators", type=str, default="mean,max,min")
    p.add_argument("--scalers", type=str, default="identity,amplification,attenuation")
    p.add_argument("--no-parity", action="store_true",
                   help="fixed semantics: all masks used + trained, independent scalers")
    p.add_argument("--subset", type=int, default=None, help="cap dataset size")
    p.add_argument("--use-pallas", action="store_true",
                   help="compatibility no-op: CUDA tensors always take the kernels")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   help="conv edge-pipeline dtype: float32 (bfloat16|auto not ported yet)")
    p.add_argument("--edge-format", type=str, default="auto",
                   help="conv edge layout: auto|csr (ell not ported yet)")
    p.add_argument("--max-degree-hint", type=int, default=4,
                   help="compatibility no-op (static in-degree bound); 0 disables")
    p.add_argument("--remat", action="store_true", help="not ported yet")
    p.add_argument("--matmul_precision", type=str, default="highest",
                   help="float32 matmul precision (highest|high|default)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--log", type=str, default=None, help="JSONL log path")
    p.add_argument("--checkpoint-dir", type=str, default=None, help="not ported yet")
    p.add_argument("--checkpoint-every", type=int, default=0, help="not ported yet")
    return p


def config_from_args(args) -> ZincConfig:
    return ZincConfig(
        aggregators=tuple(args.aggregators.split(",")),
        scalers=tuple(args.scalers.split(",")),
        lr=args.lr,
        epochs=args.epochs,
        weight_decay=args.weight_decay,
        batch_size=args.batch_size,
        hidden=args.hidden_dim,
        edge_hidden=args.edge_dim,
        towers=args.tower,
        num_layers=args.L,
        seed=args.seed,
        parity=not args.no_parity,
        subset_size=args.subset,
        use_pallas=args.use_pallas,
        compute_dtype=args.compute_dtype,
        edge_format=args.edge_format,
        max_degree_hint=args.max_degree_hint or None,
        remat=args.remat,
        matmul_precision=args.matmul_precision,
        log_path=args.log,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = train_zinc(config_from_args(args), device=args.device)
    if res["history"]:
        print(f"Final: Val: {res['val_mae']:.4f}, Test: {res['test_mae']:.4f}")
    return res


if __name__ == "__main__":
    main()
