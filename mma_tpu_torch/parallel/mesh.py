"""Process groups, device meshes and a local launcher.

The JAX package expresses its multi-device regimes over a named
``jax.sharding.Mesh`` in one process (``mma_tpu/parallel/mesh.py``). The
port runs one process per rank over ``torch.distributed``:

- :func:`initialize_distributed` joins the process group from the
  environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``). A process started without them is a
  world of one on a free local port. It takes NCCL on the card
  (``cuda:LOCAL_RANK``) and gloo on the CPU; ``backend`` overrides that, as
  for ranks that share one card (gloo, which NCCL does not allow).
- :func:`make_mesh` is ``init_device_mesh`` with the JAX axis names; a
  mesh axis's process group (``mesh.get_group("edge")``) is what the ops,
  layers and models take as ``axis_name``.
- :func:`launch_local` starts a world of W processes on this host, each
  running ``python -m mma_tpu_torch.parallel.launch module:function
  args...``, and waits for all of them.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mma_tpu_torch.device import DeviceLike, resolve_device


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(device: DeviceLike = None, backend: Optional[str] = None
                           ) -> torch.device:
    """Join the process group (see the module docstring); returns this
    rank's device. ``device=None`` or ``"cuda"`` means ``cuda:LOCAL_RANK``;
    ``"cpu"`` takes gloo."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        if world != 1:
            raise RuntimeError("MASTER_PORT is unset for a world of more than one process")
        port = str(free_port())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, **kwargs)
    return dev


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over every rank of the world. ``shape`` defaults to all ranks
    along the first axis; for 2-D layouts pass e.g. ``axis_names=("data",
    "edge"), shape=(2, 2)``. ``device_type`` defaults to the current
    device's (``"cuda"`` once :func:`initialize_distributed` set one)."""
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if device_type is None:
        device_type = ("cuda" if torch.cuda.is_available() and torch.cuda.is_initialized()
                       else "cpu")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def launch_local(target: str, world_size: int, args: Sequence[str] = (), *,
                 env: Optional[Mapping[str, str]] = None, timeout: float = 600.0,
                 cwd: Optional[str] = None) -> None:
    """Run ``target`` (``"module:function"``, called with ``args`` as
    strings) in ``world_size`` processes on this host, with the environment
    :func:`initialize_distributed` reads (``LOCAL_RANK`` = ``RANK``) and,
    unless set, ``OMP_NUM_THREADS`` = this host's cores over ``world_size``
    (ranks on the CPU would otherwise each start a thread per core).
    ``env`` adds variables (e.g. ``PYTHONPATH``). Raises if a process fails
    or the world outlasts ``timeout`` seconds; every process is stopped
    before it returns."""
    port = str(free_port())
    procs, logs = [], []
    for rank in range(world_size):
        penv = dict(os.environ)
        penv.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world_size)))
        penv.update(env or {})
        penv.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                    MASTER_ADDR="localhost", MASTER_PORT=port)
        logs.append(tempfile.TemporaryFile("w+"))  # a pipe could fill and stall the rank
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mma_tpu_torch.parallel.launch", target, *map(str, args)],
            env=penv, cwd=cwd, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    for rank, out in enumerate(outputs):
        if out:
            sys.stdout.write("".join(f"[rank {rank}] {line}\n" for line in out.splitlines()))
    if failed is not None:
        raise RuntimeError(f"{target}: rank {failed} of {world_size} exited with "
                           f"{procs[failed].returncode}:\n{outputs[failed][-4000:]}")
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"{target}: the world of {world_size} outlasted {timeout} s")
