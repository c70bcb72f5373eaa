"""The forward kernels of the serving path as ``torch.library`` custom ops.

``torch.export`` cannot trace a ctypes call, nor the host reads of the
kernels' plain versions (a CSR's bounds read as Python ints, the row ids
built from its run lengths). Each forward entry point that an eval forward
of the two models reaches is therefore one operator of the
``mma_tpu_torch`` namespace:

=============================  ========  =================================
operator                       kernel    replaces (JAX package)
=============================  ========  =================================
``segment_sum_csr``            1         ``_sum_kernel``
``edge_program_lean``          2         ``_program_fwd_lean_kernel``
``segment_minmax``             4         ``_minmax_kernel``
``minmax_edge_program``        6         ``_minmax_prog_kernel``
``segment_sum_sq_csr``         8         ``_sumsq_kernel``
=============================  ========  =================================

Each has a CPU implementation (the plain version), a CUDA implementation
(the hand-written kernel, never the plain version) and a fake
implementation that gives the output's shape and dtype from the inputs'
shapes alone (``torch.library.register_fake``, which also serves the meta
device). Inside an operator the plain version's host reads are opaque to a
tracer, so an exported graph keeps one operator call per kernel call and
serves any graph of the same padded shape. The port's wrappers call an
operator through :func:`define`'s checked callable, which refuses a
tensor on any device but the CPU and the card; called directly, the
operator raises on a device without an implementation.

The operators are defined with ``Library.define`` and ``Library.impl``,
whose dispatch costs a few microseconds a call (about a fifth of
``torch.library.custom_op``'s on the same host), because the ZINC train
step is bound by launches. They carry no autograd formula: the
``torch.autograd.Function``s of ``fused_mma`` and ``segment_minmax`` call
them in their forward and keep their backward kernels (3, 5 and 7).
Importing either module defines its operators; an exported artifact needs
them defined before it is loaded (``mma_tpu_torch.serve.load_forward``
imports both).
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "mma_tpu_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, *, cpu: Callable, cuda: Callable, fake: Callable) -> Callable:
    """Define ``mma_tpu_torch::<schema>`` with its CPU, CUDA and fake
    implementations; returns a callable of the operator's default overload
    that raises a ``ValueError`` for a tensor on another device (a meta
    tensor would otherwise take the fake implementation)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default

    def call(*args):
        for a in args:
            if isinstance(a, torch.Tensor) and a.device.type not in ("cpu", "cuda"):
                raise ValueError(f"{name}: the kernel takes CUDA tensors (its plain version "
                                 f"CPU tensors), got {a.device}")
        return op(*args)

    return call
