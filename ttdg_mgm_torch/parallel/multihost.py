"""Joining the rendezvous, and one process per local device.

Counterpart of ``ttdg_mgm_tpu/parallel/multihost.py`` and of detectron2's
``launch``.  The JAX package runs one process per host owning its local
chips; here each rank is one process: :func:`launch` starts one per local
device (``torch.multiprocessing.spawn``), and each joins the process group
through :func:`initialize_multihost` with world size machines x local
processes and rank ``machine_rank * local + local_rank``.

The backend is NCCL for CUDA devices and gloo for the CPU.  A caller may
name gloo for CUDA tensors (two ranks sharing one GPU, which NCCL refuses);
no backend is ever swapped for another here, and a failed rendezvous or
collective raises.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist

from ttdg_mgm_torch.parallel import mesh


def free_port() -> int:
    """A free TCP port on this machine (for a single-machine ``dist_url``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_method(dist_url: str) -> str:
    """``tcp://host:port`` (the reference's form) or a bare ``host:port``;
    ``file://`` and ``env://`` pass through."""
    if "://" in dist_url:
        return dist_url
    return "tcp://" + dist_url


def initialize_multihost(dist_url: str, num_machines: int = 1, machine_rank: int = 0, *,
                         local_rank: int = 0, local_size: int = 1, device: str = "cuda",
                         backend: str | None = None, timeout_s: float | None = None) -> None:
    """Join the process group of ``num_machines`` machines with
    ``local_size`` processes each, as local rank ``local_rank`` of machine
    ``machine_rank`` (reference ``launch``/``dist_url``).  ``backend``
    defaults to NCCL for ``device`` ``"cuda"`` and gloo for ``"cpu"``.
    On CUDA the process's device is set first: the one ``device`` names
    (``cuda:N``), else ``cuda:local_rank``.
    ``timeout_s`` bounds the rendezvous and every collective (the torch
    default when None)."""
    dev = torch.device(device)
    dev_type = dev.type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if backend == "nccl" and dev_type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices; use gloo on the CPU")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank was asked for and no GPU is available")
        torch.cuda.set_device(dev.index if dev.index is not None else
                              local_rank if backend == "nccl" else
                              local_rank % torch.cuda.device_count())
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend=backend, init_method=_init_method(dist_url),
                            world_size=num_machines * local_size,
                            rank=machine_rank * local_size + local_rank, **kw)
    mesh._local = (local_rank, local_size)


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if mesh.active():
        dist.destroy_process_group()
    mesh._local = (0, 1)


def _rank_main(local_rank, fn, dist_url, num_machines, machine_rank, local_size, device,
               backend, timeout_s, args):
    initialize_multihost(dist_url, num_machines, machine_rank, local_rank=local_rank,
                         local_size=local_size, device=device, backend=backend,
                         timeout_s=timeout_s)
    try:
        fn(*args)
    finally:
        shutdown()


def launch(fn, local_size: int, *, dist_url: str, num_machines: int = 1, machine_rank: int = 0,
           device: str = "cuda", backend: str | None = None, args=(),
           timeout_s: float | None = None) -> None:
    """Run ``fn(*args)`` in ``local_size`` spawned processes of this
    machine, each a rank of the process group (detectron2's ``launch``).
    ``fn`` must be importable by name.  Raises when a rank fails, and
    ``TimeoutError`` (after terminating the ranks) when they have not all
    ended within ``timeout_s``; the same bound applies to the rendezvous and
    the collectives."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(fn, dist_url, num_machines, machine_rank, local_size, device, backend,
                          timeout_s, args),
        nprocs=local_size, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=None if deadline is None else max(deadline - time.monotonic(),
                                                                  0.0)):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{local_size} ranks did not end within {timeout_s} s")


def allgather_metrics(obj) -> list:
    """Every rank's ``obj`` (a picklable host value), in rank order
    (reference ``comm.all_gather``); ``[obj]`` without a process group."""
    if not mesh.active():
        return [obj]
    out = [None] * mesh.world_size()
    dist.all_gather_object(out, obj)
    return out
