"""One rank of a world that :func:`~mma_tpu_torch.parallel.mesh.launch_local`
starts: ``python -m mma_tpu_torch.parallel.launch module:function args...``
imports ``module`` and calls ``function(*args)``; the function joins the
process group itself (``initialize_distributed``). The process group is
destroyed when the function returns."""

from __future__ import annotations

import importlib
import sys

import torch.distributed as dist


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    module, _, name = argv[0].partition(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        fn(*argv[1:])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
