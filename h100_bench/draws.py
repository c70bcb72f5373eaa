"""Recording the random draws of a program's calls, for a reference to reuse.

A training step's dropout keeps are the program's own: the order it
draws them in, their shapes and padding and the order of their rows are
its business, and a later version may draw them otherwise. So the
checked steps run under :class:`Recorder`, which keeps a host copy of
the output of every random operation (those PyTorch tags
``nondeterministic_seeded``: ``rand``, ``bernoulli``, ``uniform_`` ...)
in the order made, and the reference reads the keeps from those copies
instead of drawing them again. A draw made inside a
hand-written kernel is not an operation of PyTorch's and is not seen.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class Recorder(TorchDispatchMode):
    """``with Recorder() as rec:`` — ``rec.draws`` lists ``(operation name,
    host copy of its output)`` of every random operation in the block."""

    def __init__(self):
        super().__init__()
        self.draws: List[Tuple[str, torch.Tensor]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.Tag.nondeterministic_seeded in func.tags and isinstance(out, torch.Tensor):
            self.draws.append((func.overloadpacket.__name__, out.detach().to("cpu", copy=True)))
        return out

