"""The run configs and the README presets.

Copies of the JAX package's ``NodeClassificationConfig``,
``NODE_CLS_PRESETS``, ``ZincConfig`` and ``ZINC_PRESET``
(``mma_tpu/train/config.py``), field for field, so a config means the same
run in both packages. Fields that read differently:

- ``use_pallas`` is kept for command-line compatibility and does nothing:
  the device decides (CUDA tensors take the kernels, CPU tensors their
  plain versions).
- ``matmul_precision`` maps to ``torch.set_float32_matmul_precision``:
  ``"highest"`` (the default) keeps float32 products in full float32, the
  counterpart of the JAX package's full-f32 MXU passes; ``"high"`` allows
  TF32 and ``"default"`` bf16-class products; ``None`` leaves the
  process's setting alone.
- ``ZincConfig.max_degree_hint`` does nothing (the CUDA kernels need no
  scan bound). ``edge_format="auto"`` and ``batch_layout="auto"`` resolve
  to the CSR route and the plain collate, where the JAX package takes the
  degree-exact ELL layout; without dropout both compute the same
  function. ``"ell"``, ``"degree_exact"``, ``remat`` and a
  ``compute_dtype`` other than float32 are not ported yet and raise.

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


@dataclasses.dataclass(frozen=True)
class ZincConfig:
    aggregators: Tuple[str, ...] = ("min", "max")
    scalers: Tuple[str, ...] = ("identity", "amplification", "linear")
    lr: float = 1e-4
    epochs: int = 200
    weight_decay: float = 3e-4
    batch_size: int = 64  # the reference hardcodes 64 (mma.py:52-54)
    hidden: int = 75
    edge_hidden: int = 50
    towers: int = 5
    num_layers: int = 4
    pre_layers: int = 1
    post_layers: int = 1
    mlp_sizes: Tuple[int, ...] = (75, 50, 25, 1)
    # ReduceLROnPlateau (mma.py:137)
    lr_factor: float = 0.5
    lr_patience: int = 20
    min_lr: float = 1e-5
    seed: int = 42
    parity: bool = True
    parity_eval_dropout: bool = False
    subset_size: Optional[int] = None  # cap dataset size (CI/smoke)
    n_node_per_graph: int = 40  # padding budget per graph slot
    n_edge_per_graph: int = 100
    use_pallas: bool = False  # compatibility no-op: the device decides
    remat: bool = False
    compute_dtype: str = "float32"
    edge_format: str = "auto"
    max_degree_hint: Optional[int] = 4
    batch_layout: str = "auto"
    matmul_precision: Optional[str] = "highest"
    log_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False


# README.md:79 (``--aggregators min,max --scalers identity,amplification,linear``).
ZINC_PRESET = ZincConfig(
    aggregators=("min", "max"),
    scalers=("identity", "amplification", "linear"),
    weight_decay=3e-4, lr=1e-4, epochs=10000,
)
