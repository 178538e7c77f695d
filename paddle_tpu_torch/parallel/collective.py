"""Distributed bootstrap and collectives over ``torch.distributed`` (the
counterpart of ``paddle_tpu/parallel/collective.py``).

The reference's collectives name a mesh axis bound by ``shard_map``;
here they take that axis's process group (``Mesh.group(name)``), None
for an axis of one rank, where each is the identity.  Every collective
returns a new tensor and leaves its input as it was.

The backend is the caller's choice (``init_distributed_env``): NCCL by
default where CUDA is present, one rank per card.  gloo also runs on
CUDA tensors for all-reduce and broadcast, so two ranks can share one
card over it; its all-gather takes CPU tensors only, so ``all_gather``
stages a CUDA tensor through the host on a gloo group.  No backend is
ever switched for another on failure.
"""

import contextlib
import os

import torch
import torch.distributed as dist

__all__ = [
    "init_distributed_env", "all_reduce", "all_gather", "broadcast",
    "barrier", "trainer_id", "num_trainers", "recording",
]


def trainer_id():
    return int(os.environ.get("PADDLE_TRAINER_ID",
                              os.environ.get("TRAINER_ID", 0)))


def num_trainers():
    return int(os.environ.get("PADDLE_TRAINERS",
                              os.environ.get("TRAINERS", 1)))


def init_distributed_env(coordinator_address=None, num_processes=None,
                         process_id=None, backend=None):
    """Join this process to the job's process group.

    The coordinator defaults to the first of PADDLE_TRAINER_ENDPOINTS,
    the process count and id to PADDLE_TRAINERS / PADDLE_TRAINER_ID, as
    in the reference.  An address with a scheme (``tcp://``,
    ``file://``) is used as it is; a bare ``host:port`` becomes
    ``tcp://host:port``.  `backend` defaults to ``nccl`` where CUDA is
    available, else ``gloo``.  A single process joins nothing."""
    if coordinator_address is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        if eps:
            coordinator_address = eps.split(",")[0]
    if num_processes is None:
        num_processes = num_trainers()
    if process_id is None:
        process_id = trainer_id()
    if num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError("init_distributed_env: %d processes need a "
                         "coordinator address" % num_processes)
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

# the open recordings: lists of (kind, bytes).  Process-wide, not a
# context variable: a collective under a CUDA tensor's backward runs on
# the autograd engine's device thread
_recordings = []


@contextlib.contextmanager
def recording():
    """Yields a list that collects (kind, bytes) of every collective this
    process issues over a group inside the block: "all-reduce" and
    "all-gather" (the reference's HLO names) and "broadcast", each with
    the bytes of its result, as the reference counts a collective's
    output bytes."""
    log = []
    _recordings.append(log)
    try:
        yield log
    finally:
        _recordings.remove(log)


def _record(kind, t):
    for log in _recordings:
        log.append((kind, t.numel() * t.element_size()))


def all_reduce(x, axis, op="sum"):
    """The element-wise sum, max, min or mean of `x` over the ranks of
    `axis` (a process group; None is one rank)."""
    if op not in _OPS and op != "mean":
        raise ValueError("all_reduce: op %r (sum, max, min, mean)" % op)
    out = x.clone()
    if axis is None:
        return out
    dist.all_reduce(out, op=_OPS.get(op, dist.ReduceOp.SUM), group=axis)
    _record("all-reduce", out)
    if op == "mean":
        out = out / dist.get_world_size(axis)
    return out


def all_gather(x, axis, dim=0):
    """The ranks' `x` concatenated along `dim`, in rank order of
    `axis`."""
    if axis is None:
        return x.clone()
    staged = x.is_cuda and dist.get_backend(axis) == "gloo"
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(axis))]
    dist.all_gather(parts, src, group=axis)
    out = torch.cat(parts, dim=dim)
    _record("all-gather", out)
    return out.to(x.device) if staged else out


def broadcast(x, axis, src=0):
    """Rank `src` (its index along `axis`) sends `x` to every rank."""
    out = x.clone()
    if axis is None:
        return out
    dist.broadcast(out, src=dist.get_global_rank(axis, src), group=axis)
    _record("broadcast", out)
    return out


def barrier(axis=None):
    """Wait for every rank of `axis` (the whole job for None, when a
    process group is initialized)."""
    if axis is not None or dist.is_initialized():
        dist.barrier(group=axis)
