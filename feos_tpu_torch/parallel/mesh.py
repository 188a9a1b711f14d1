"""Data parallelism across processes, one card each, with ``torch.distributed``.

Counterpart of ``feos_tpu/parallel/mesh.py``.  Rows are independent, so the
solves need no collective: each process solves its contiguous block of the
batch, :func:`gather_batch` puts the blocks back in global row order, and
only a fit's loss terms, converged counts and parameter gradient are summed
across processes (``regression.py``).

Nothing on a card's machine describes a cluster, so the coordinator's
address, the number of processes, this process's rank and its device are
always given explicitly: :func:`initialize_multi_host` builds the process
group, :func:`batch_mesh` describes this process's place in it.  NCCL wants
``torch.cuda.set_device`` called before the group is built, and every
group is torn down by ``torch.distributed.destroy_process_group``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


def initialize_multi_host(coordinator_address=None, num_processes=None, process_id=None, *,
                          backend=None, init_method=None):
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, rendezvousing at ``tcp://<coordinator_address>`` (host
    and port) or at ``init_method`` (a ``file://`` store, for one machine).

    ``backend`` defaults to ``nccl`` where CUDA is available and ``gloo``
    otherwise.  A no-op returning ``(0, 1)`` when neither an address nor an
    ``init_method`` is given and no group exists; with a group already
    built it reports that group.  A failed rendezvous raises: a process
    that silently went on alone would fit on a fraction of the data.

    Returns ``(rank, world_size)``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and init_method is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required with a coordinator")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method or f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


@dataclass(frozen=True)
class BatchMesh:
    """This process's place in a 1-D batch mesh: its ``rank`` of
    ``world_size`` processes in ``group`` (None: the default group, or no
    group at all when ``world_size`` is 1 without one) and the ``device``
    its block of rows lives on."""

    rank: int
    world_size: int
    group: object
    device: torch.device
    distributed: bool  # a process group exists: blocks and sums go through it

    def block(self, n):
        """The slice of this rank's contiguous block of ``n`` rows."""
        if n % self.world_size:
            raise ValueError(f"{n} rows do not split over {self.world_size} processes; "
                             "pad them with pad_to_multiple")
        size = n // self.world_size
        return slice(self.rank * size, (self.rank + 1) * size)


def batch_mesh(device=None, group=None) -> BatchMesh:
    """The batch mesh of this process over ``group`` (default: the whole
    process group of :func:`initialize_multi_host`; without one, a mesh of
    this process alone), its rows on ``device`` (default: the current card)."""
    distributed = dist.is_initialized()
    rank = dist.get_rank(group) if distributed else 0
    world_size = dist.get_world_size(group) if distributed else 1
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return BatchMesh(rank, world_size, group, torch.device(device), distributed)


def pad_to_multiple(x, multiple: int, fill=np.nan):
    """Pad the leading axis to a multiple (required for even sharding).

    Returns ``(padded, n_valid)``; padded rows are filled with ``fill`` and
    are expected to fail the solver's convergence mask (NaN rows always do),
    so they drop out of masked reductions naturally.
    """
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad_width, constant_values=fill), n


def shard_batch(x, mesh: BatchMesh):
    """This rank's contiguous block of the leading axis of ``x`` (an array
    or tensor of the global batch), as a tensor on ``mesh.device``; float
    data become float64."""
    x = torch.as_tensor(x)
    if x.is_floating_point():
        x = x.to(torch.float64)
    return x[mesh.block(x.shape[0])].to(mesh.device)


def gather_batch(x: torch.Tensor, mesh: BatchMesh) -> torch.Tensor:
    """The inverse of :func:`shard_batch`: every rank's block of ``x``
    (each the same shape), concatenated in global row order on every rank.
    Bool blocks travel as uint8 (gloo gathers no bool)."""
    if not mesh.distributed:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    wire = wire.contiguous()
    blocks = [torch.empty_like(wire) for _ in range(mesh.world_size)]
    dist.all_gather(blocks, wire, group=mesh.group)
    out = torch.cat(blocks)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_reduce_sum(x: torch.Tensor, mesh: BatchMesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, on every rank (a new
    tensor; ``x`` is left as it was)."""
    out = x.detach().clone()
    if mesh.distributed:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def data_parallel(fn, mesh: BatchMesh, n_batched_args: int):
    """Run a row-independent ``fn`` on this rank's rows.

    The first ``n_batched_args`` arguments hold the global batch and are
    sharded on their leading axis (:func:`shard_batch`); the rest are passed
    as they are.  Each output (a tensor or a tuple of them, the batch
    leading) is gathered back in global row order (:func:`gather_batch`).
    """
    def wrapped(*args):
        local = [shard_batch(a, mesh) if i < n_batched_args else a for i, a in enumerate(args)]
        out = fn(*local)
        if isinstance(out, tuple):
            return tuple(gather_batch(o, mesh) for o in out)
        return gather_batch(out, mesh)

    return wrapped
