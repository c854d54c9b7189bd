"""The data-parallel world over the default process group.

Counterpart of ``ttdg_mgm_tpu/parallel/mesh.py``.  The JAX package runs
one process per host over a ``data`` mesh axis: the state is replicated,
the global batch is sharded over the axis, each shard's loss and gradients
are computed locally and ``pmean``-ed before the optimizer.  Here each
rank is one process (one GPU, or a gloo rank on the CPU) holding the whole
state; :func:`shard_batch` takes its slice of the global batch and
:func:`all_reduce_mean` is the ``pmean``.

Without a process group the world is one rank and every function here is a
no-op, so a single-process run is unchanged bit for bit.  With a group of
one rank the reduction still runs (a sum over one rank divided by 1, which
is exact).

The JAX mesh's second, ``model``, axis is not ported: no JAX step shards
anything but ``data`` (:func:`data_axis_size` raises on it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: this process's place on its machine: ``(local rank, local processes)``,
#: set by ``multihost.initialize_multihost``
_local = (0, 1)


def active() -> bool:
    """True when a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def local_rank() -> int:
    return _local[0] if active() else 0


def is_main_process() -> bool:
    return rank() == 0


def data_axis_size(mesh_shape, local_devices: int) -> int:
    """Data ranks per machine from ``TPU.MESH_SHAPE``, as
    ``ttdg_mgm_tpu/build.py:build_mesh`` reads it: ``[-1]`` (or ``[]``) is
    every local device, ``[n]`` is ``n`` of them.  A ``model`` axis above 1
    raises ``ValueError``, as does asking for more devices than there are."""
    shape = list(mesh_shape)
    if len(shape) > 2:
        raise ValueError(f"TPU.MESH_SHAPE {shape}: at most two axes (data, model)")
    if len(shape) == 2 and shape[1] not in (-1, 0, 1):
        raise ValueError(f"TPU.MESH_SHAPE {shape}: a model axis above 1 is not supported; "
                         "the steps shard the data axis only")
    n = shape[0] if shape and shape[0] > 0 else local_devices
    if n > local_devices:
        raise ValueError(f"TPU.MESH_SHAPE {shape} asks for {n} data ranks on a machine with "
                         f"{local_devices} device(s)")
    return n


def shard_batch(batch: dict) -> dict:
    """This rank's slice ``[r * b / w, (r + 1) * b / w)`` of every value's
    leading axis (every rank holds the same global batch, as every JAX
    process holds the global host batch)."""
    w = world_size()
    if w == 1:
        return batch
    b = next(iter(batch.values())).shape[0]
    assert b % w == 0, (
        f"global batch {b} not divisible by data-mesh size {w} "
        "(the reference's d2 loader asserts the same for DDP, "
        "data/build.py:241-255)")
    n, r = b // w, rank()
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


@torch.no_grad()
def all_reduce_mean(tensors) -> list:
    """Average ``tensors`` over the ranks in place (JAX ``lax.pmean``): one
    flat buffer per dtype, summed over the ranks, then divided by the
    world size.  Under gloo a CUDA buffer is summed through a host copy.
    Returns ``tensors``."""
    tensors = list(tensors)
    if not active():
        return tensors
    w = world_size()
    staged = dist.get_backend() == "gloo"
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        if staged and flat.is_cuda:
            host = flat.cpu()
            dist.all_reduce(host, op=dist.ReduceOp.SUM)
            flat.copy_(host)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(w)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


def barrier() -> None:
    if active():
        dist.barrier()
