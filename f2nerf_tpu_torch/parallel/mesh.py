"""The data mesh and its collectives (port of
``f2nerf_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a 1-D ``data`` mesh: the ray
batch is sharded along it, params and constants are replicated, and
GSPMD inserts the gradient all-reduce. The port runs one process per
card (``torchrun``), each holding a full copy of params, constants,
optimizer state and occupancy grid, and rendering its contiguous shard
of every batch; the collectives are explicit ``torch.distributed`` calls
on the :class:`DataMesh`'s process group:

* :func:`all_reduce_sum`: the train step's gradient sum, the global
  denominators of its ratio losses, its metrics, the localizer's pose
  gradient and loss;
* :func:`all_gather_rows`: a sharded VALIDATE render's rows, so every
  rank returns the whole image;
* :func:`replicate`: a broadcast from rank 0, so the ranks start equal.

The gather is an ``all_reduce(SUM)`` of a zero-filled buffer in which
each rank writes its own rows (``x + 0 == x``, so it is exact): one code
path on NCCL, on gloo with CPU tensors and on gloo with CUDA tensors,
where gloo offers ``broadcast`` and ``all_reduce`` only.

Every collective runs inside ``record_function("mesh/all_reduce")`` (or
``"mesh/broadcast"``), which a profile reads for the collective's share.

``data_sharding`` and ``replicated`` (JAX ``NamedSharding``s) have no
counterpart: a rank's tensors are its own, and placement is the slicing
of :func:`shard_batch` and the broadcast of :func:`replicate`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from f2nerf_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
# a collective that waits longer fails instead of hanging the run
TIMEOUT = datetime.timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: this process's ``rank`` of ``size``, its
    ``device``, and the process ``group`` its collectives run on (None:
    a single process with no process group, where every collective is
    the identity)."""
    group: Any
    rank: int
    size: int
    device: torch.device


def maybe_initialize_distributed(backend: str | None = None,
                                 device: str | torch.device | None = None
                                 ) -> torch.device | None:
    """Join the process group described by ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) and return this process's device; without that
    environment, do nothing and return None.

    The device is ``cuda:LOCAL_RANK`` unless ``device`` names one; it
    raises when ``LOCAL_RANK`` has no card of its own (it never shares a
    card or falls back to the CPU unasked). The backend is NCCL for a
    CUDA device and gloo for the CPU unless ``backend`` names one.
    Collectives that wait longer than ``TIMEOUT`` raise.
    """
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        n_cards = (torch.cuda.device_count() if torch.cuda.is_available()
                   else 0)
        if local >= n_cards:
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card of its own ({n_cards} "
                f"visible); pass device= to choose one")
        dev = torch.device("cuda", local)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        extra = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank, timeout=TIMEOUT,
                                **extra)
    return dev


def make_mesh(device: str | torch.device | None = None) -> DataMesh:
    """The mesh over the initialized default process group (without one,
    a single-process mesh of size 1). ``device`` defaults to the card and
    raises without one (``core/device.py``)."""
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return DataMesh(None, 0, 1, dev)
    group = dist.group.WORLD
    return DataMesh(group, dist.get_rank(group), dist.get_world_size(group),
                    dev)


def shard_batch(mesh: DataMesh | None, *arrays):
    """This rank's contiguous rows ``[r*B/k, (r+1)*B/k)`` of each array
    (numpy arrays or tensors). Raises unless the mesh size k divides the
    batch B."""
    if mesh is None or mesh.size == 1:
        return arrays
    out = []
    for a in arrays:
        b = a.shape[0]
        if b % mesh.size:
            raise ValueError(f"mesh size {mesh.size} must divide the batch "
                             f"of {b} rows")
        n = b // mesh.size
        out.append(a[mesh.rank * n:(mesh.rank + 1) * n])
    return tuple(out)


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(mesh: DataMesh | None, tree: Any) -> Any:
    """Overwrite every tensor in ``tree`` (nested dicts, lists, tuples)
    in place with rank 0's, so the ranks start equal; returns ``tree``.
    A tensor off the mesh's device (torch Adam's ``step`` counters) goes
    through a copy on it."""
    if mesh is None or mesh.group is None:
        return tree
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad(), torch.profiler.record_function("mesh/broadcast"):
        for t in _tensors(tree):
            buf = t if t.device == mesh.device else t.to(mesh.device)
            dist.broadcast(buf, src=src, group=mesh.group)
            if buf is not t:
                t.copy_(buf)
    return tree


def all_reduce_sum(mesh: DataMesh | None, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; returns ``t``. Every rank
    gets the same values."""
    if mesh is not None and mesh.group is not None:
        with torch.profiler.record_function("mesh/all_reduce"):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather_rows(mesh: DataMesh | None, local: torch.Tensor
                    ) -> torch.Tensor:
    """Every rank's ``local`` [n, ...] stacked in rank order, [k*n, ...],
    on every rank: an exact all-gather (a zero-filled buffer holding this
    rank's rows, summed over the ranks)."""
    if mesh is None or mesh.group is None:
        return local
    n = local.shape[0]
    out = local.new_zeros((n * mesh.size, *local.shape[1:]))
    out[mesh.rank * n:(mesh.rank + 1) * n] = local
    return all_reduce_sum(mesh, out)


def any_rank(mesh: DataMesh | None, flag: bool) -> bool:
    """Whether ``flag`` is true on any rank (a host decision every rank
    then takes alike)."""
    if mesh is None or mesh.group is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    return bool(all_reduce_sum(mesh, t).item() > 0)


def barrier(mesh: DataMesh | None) -> None:
    """Wait until every rank of the mesh gets here."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def is_writer(mesh: DataMesh | None) -> bool:
    """Whether this process writes the run's files (rank 0 only)."""
    return mesh is None or mesh.rank == 0
