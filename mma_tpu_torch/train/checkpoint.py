"""Checkpoint/resume of a training payload.

The port of the JAX package's ``mma_tpu/train/checkpoint.py`` (orbax there)
with the same three functions and the same ``step_{step:08d}`` names. A
payload is a tree of dicts, lists and tuples over tensors, Python numbers,
strings and None: a module's and an optimizer's ``state_dict``, a
``torch.Generator``'s ``get_state()`` (a CPU ``ByteTensor``), a
scheduler's numbers.

- :func:`save_checkpoint` writes one file per step with ``torch.save``,
  under a temporary name that :func:`latest_step` does not parse, then
  renames it into place (``os.replace``), so that a reader never sees half
  a step, as orbax's commit does.
- :func:`restore_checkpoint` loads with ``torch.load(weights_only=True)``:
  nothing in a checkpoint is unpickled as code.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

_PREFIX = "step_"


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"{_PREFIX}{step:08d}")


def save_checkpoint(directory: str, step: int, payload: Any) -> str:
    """Write ``payload`` as step ``step`` of ``directory``; returns its path.
    An existing step is replaced."""
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest step saved in ``directory``, or None; names that do not
    parse as ``step_<int>`` are skipped."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith(_PREFIX):
            try:
                steps.append(int(name[len(_PREFIX):]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _place(payload: Any, target: Any, where: str) -> Any:
    """``payload`` checked against ``target``'s structure, its tensors on
    the target's devices and dtypes."""
    if isinstance(target, torch.Tensor):
        if not isinstance(payload, torch.Tensor) or payload.shape != target.shape:
            got = tuple(payload.shape) if isinstance(payload, torch.Tensor) else type(payload)
            raise ValueError(f"checkpoint {where}: expected a tensor of shape "
                             f"{tuple(target.shape)}, got {got}")
        return payload.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(payload, dict) or set(payload) != set(target):
            got = sorted(map(str, payload)) if isinstance(payload, dict) else type(payload)
            raise ValueError(f"checkpoint {where}: expected keys {sorted(map(str, target))}, "
                             f"got {got}")
        return {k: _place(payload[k], target[k], f"{where}[{k!r}]") for k in target}
    if isinstance(target, (list, tuple)):
        if type(payload) is not type(target) or len(payload) != len(target):
            raise ValueError(f"checkpoint {where}: expected a {type(target).__name__} of "
                             f"{len(target)}, got {type(payload).__name__}")
        return type(target)(_place(p, t, f"{where}[{i}]")
                            for i, (p, t) in enumerate(zip(payload, target)))
    if type(payload) is not type(target):
        raise ValueError(f"checkpoint {where}: expected {type(target).__name__}, "
                         f"got {type(payload).__name__}")
    return payload


def restore_checkpoint(directory: str, step: Optional[int] = None, target: Any = None):
    """Restore ``step`` (default: the latest) → ``(step, payload)``, or
    ``(None, None)`` when ``directory`` holds no step.

    Without ``target`` the tensors come back on the devices they were saved
    from. With ``target``, an example payload, the checkpoint's structure
    must match it (the same dict keys, sequence types and lengths, tensor
    shapes and leaf types) or this raises, and each tensor lands on its
    target's device and dtype: a checkpoint written on the card restores to
    the CPU for a CPU target, and the other way round.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    path = _ckpt_path(directory, step)
    payload = torch.load(path, weights_only=True,
                         map_location=None if target is None else "cpu")
    if target is not None:
        payload = _place(payload, target, "payload")
    return step, payload
