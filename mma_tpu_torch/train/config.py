"""The node-classification run config and the README presets.

A copy of the JAX package's ``NodeClassificationConfig`` and
``NODE_CLS_PRESETS`` (``mma_tpu/train/config.py``), field for field, so a
config means the same run in both packages. Two fields read differently:

- ``use_pallas`` is kept for command-line compatibility and does nothing:
  the device decides (CUDA tensors take the kernels, CPU tensors their
  plain versions).
- ``matmul_precision`` maps to ``torch.set_float32_matmul_precision``:
  ``"highest"`` (the default) keeps float32 products in full float32, the
  counterpart of the JAX package's full-f32 MXU passes; ``"high"`` allows
  TF32 and ``"default"`` bf16-class products; ``None`` leaves the
  process's setting alone.

Checkpointing (``checkpoint_dir``, ``checkpoint_every``, ``resume``) is
not ported yet; a run that asks for it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NodeClassificationConfig:
    dataset: str = "cora"
    aggregators: Tuple[str, ...] = ("mean", "max", "min")  # train.py:33 default
    scalers: Tuple[str, ...] = ("identity", "amplification", "attenuation")
    lr: float = 0.01
    epochs: int = 200
    weight_decay: float = 5e-4
    hidden: int = 16
    dropout: float = 0.5
    activation: str = "new_sigmoid"
    sigmoid_k: float = 2.0
    seed: int = 42
    parity: bool = True
    parity_eval_dropout: bool = False  # N2: reference eval keeps dropout on
    fastmode: bool = False  # train.py:21 — skip the eval-mode re-forward
    use_pallas: bool = False  # compatibility no-op: the device decides
    matmul_precision: Optional[str] = "highest"
    log_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # epochs; 0 = off
    resume: bool = False


# README-reproduction presets (README.md:58,64,70 / BASELINE.md).
NODE_CLS_PRESETS = {
    "pubmed": NodeClassificationConfig(
        dataset="pubmed",
        aggregators=("min", "min2", "min3", "min4"),
        lr=0.01, epochs=500, weight_decay=5e-4, hidden=16, dropout=0.5,
    ),
    "citeseer": NodeClassificationConfig(
        dataset="citeseer",
        aggregators=("min", "min2", "min3"),
        lr=0.01, epochs=500, weight_decay=3e-4, hidden=128, dropout=0.5,
    ),
    "cora": NodeClassificationConfig(
        dataset="cora",
        aggregators=("mean", "mean2"),
        lr=0.001, epochs=200, weight_decay=3e-4, hidden=64, dropout=0.75,
    ),
}
