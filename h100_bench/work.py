"""Counting rules shared by the configurations' work functions.

The work of a call is what its inputs need, whatever implements it
(``PERF.md`` §6's rule): each input read once, each output written once,
and the arithmetic of the model's equations at the real (unpadded)
sizes. Conventions: an add, a multiply or a compare is 1 FLOP, a
matrix product ``(m, k) @ (k, n)`` is ``2·m·k·n``, a sigmoid is 3 (an
exponential, an add and a divide), an exponential or a logarithm 1.
Random draws (dropout keeps) cost nothing: they can be made in registers.
"""

from __future__ import annotations

from typing import Dict

F32 = 4
I32 = 4
I64 = 8


def matmul(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def least_seconds(flops: float, nbytes: float, peaks: Dict[str, float], dtype: str) -> float:
    """The least time the card could take: max(bytes / HBM rate, FLOPs /
    the peak of ``dtype``)."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks[f"{dtype}_flops_per_s"])
