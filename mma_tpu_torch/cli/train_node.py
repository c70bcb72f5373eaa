"""Node-classification CLI — the flags of the JAX package's
``mma_tpu.cli.train_node`` (flag-compatible with the reference
``node_classification/train.py:19-35``), plus ``--device``.

The run goes on the GPU unless ``--device cpu`` is given (the kernels'
plain PyTorch versions). ``--use-pallas`` is accepted and does nothing:
the device decides. ``--checkpoint-dir`` with ``--checkpoint-every N``
saves a checkpoint every N epochs.

Usage (reproduces README.md:70):
    python -m mma_tpu_torch.cli.train_node --dataset cora \\
        --aggregators mean,mean2 --lr 0.001 --epochs 200 \\
        --weight_decay 3e-4 --hidden 64 --dropout 0.75
"""

from __future__ import annotations

import argparse

from mma_tpu_torch.train import NodeClassificationConfig, train_node_classification


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", type=str, default="cora")
    p.add_argument("--aggregators", type=str, default="mean,max,min")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--activation", type=str, default="new_sigmoid")
    p.add_argument("--k", type=float, default=2, help="sigmoid k (inert: dead branch, N1)")
    p.add_argument("--fastmode", action="store_true", default=False)
    p.add_argument("--no-parity", action="store_true",
                   help="use fixed (intended) semantics instead of reference parity")
    p.add_argument("--use-pallas", action="store_true",
                   help="compatibility no-op: CUDA tensors always take the kernels")
    p.add_argument("--matmul_precision", type=str, default="highest",
                   help="float32 matmul precision (highest|high|default)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--log", type=str, default=None, help="JSONL log path")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="directory of the training checkpoints")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a checkpoint every N epochs (0: never)")
    # Reference-compat no-ops (parsed-but-ignored there too):
    p.add_argument("--no-cuda", action="store_true", help="compat no-op")
    p.add_argument("--early_stopping", type=int, default=10, help="compat no-op")
    p.add_argument("--max_degree", type=int, default=3, help="compat no-op")
    p.add_argument("--start_test", type=int, default=80, help="compat no-op")
    p.add_argument("--train_jump", type=int, default=0, help="compat no-op")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = NodeClassificationConfig(
        dataset=args.dataset,
        aggregators=tuple(args.aggregators.split(",")),
        lr=args.lr,
        epochs=args.epochs,
        weight_decay=args.weight_decay,
        hidden=args.hidden,
        dropout=args.dropout,
        activation=args.activation,
        sigmoid_k=args.k,
        seed=args.seed,
        parity=not args.no_parity,
        fastmode=args.fastmode,
        use_pallas=args.use_pallas,
        matmul_precision=args.matmul_precision,
        log_path=args.log,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    res = train_node_classification(cfg, device=args.device)
    print(f"Test set results: loss= {res['loss_test']:.4f} accuracy= {res['acc_test']:.4f}")
    return res


if __name__ == "__main__":
    main()
