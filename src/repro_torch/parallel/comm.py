"""The one point where a rank issues a collective.

Every collective of the training and serving steps goes through a
function here (``parallel/tensor.py``'s axes and shard groups, the
pipeline's ``StageGroup``, the outer step's payload gather, the driver's
sums over the clusters group), which records ``(axis, kind, bytes)``:
``counts[(axis, kind)]`` holds ``[calls, bytes]`` since the last
``reset``, beside the kernels' launch counts, and inside ``recording()``
each entry is also appended, in issue order.

A group is a ``torch.distributed`` process group or a ``MetaGroup``: one
rank's view of a group of ``size`` ranks on the ``meta`` device (the
dry-run, ``launch/dryrun.py``). There a collective issues nothing and
records the same entry: its outputs are the buffers the caller allocated,
whose shapes are what the collective would return, and whose ``meta``
storage holds no data.

``bytes`` is the larger of what the call hands over and what it fills on
this rank: an all-gather (and a gather on its root) the gathered whole, a
scatter on its root every part, an all-to-all, all-reduce, broadcast,
send or receive its tensor, a gather or scatter elsewhere its block. (The
JAX dry-run counts a collective's output size; the two agree for the
all-gathers, all-reduces and all-to-alls that carry the bytes.)

Axis names: ``"clusters"``, ``"data"``, ``"model"`` (the pipeline's stages
are the "model" axis) and ``"data,model"`` (a cluster's D x M ranks).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

Entry = Tuple[str, str, int]

counts: Dict[Tuple[str, str], List[int]] = {}
_log: Optional[List[Entry]] = None


class MetaGroup:
    """Rank ``rank`` of a group of ``size`` ranks, on the meta device."""

    def __init__(self, size: int, rank: int = 0):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.size, self.rank = size, rank

    def __repr__(self):
        return f"MetaGroup(size={self.size}, rank={self.rank})"


class _Done:
    def wait(self):
        return True


def is_meta(group) -> bool:
    return isinstance(group, MetaGroup)


def size(group) -> int:
    """The group's number of ranks (1 with no group)."""
    if group is None:
        return 1
    if is_meta(group):
        return group.size
    import torch.distributed as dist
    return dist.get_world_size(group)


def global_rank(group, r: int) -> int:
    """The global rank of group rank ``r`` (``r`` itself on meta)."""
    if is_meta(group):
        return r
    import torch.distributed as dist
    return dist.get_global_rank(group, r)


def reset() -> None:
    counts.clear()


@contextlib.contextmanager
def recording():
    """Yields the list of the entries recorded inside the block."""
    global _log
    outer, _log = _log, []
    try:
        yield _log
    finally:
        if outer is not None:
            outer.extend(_log)
        _log = outer


def _record(axis: str, kind: str, nbytes: int) -> None:
    c = counts.setdefault((axis, kind), [0, 0])
    c[0] += 1
    c[1] += nbytes
    if _log is not None:
        _log.append((axis, kind, nbytes))


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, group, axis: str) -> List[torch.Tensor]:
    """Every rank's ``x``, in group rank order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(size(group))]
    _record(axis, "all_gather", len(out) * nbytes(x))
    if not is_meta(group):
        import torch.distributed as dist
        dist.all_gather(out, x, group=group)
    return out


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group,
                    axis: str) -> torch.Tensor:
    """``out`` (size x ``x``, flat) filled with every rank's ``x``."""
    _record(axis, "all_gather", nbytes(out))
    if not is_meta(group):
        import torch.distributed as dist
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_to_all(chunks: List[torch.Tensor], group, axis: str
               ) -> List[torch.Tensor]:
    """Chunk r to rank r; returns what each rank sent this one."""
    got = [torch.empty_like(c) for c in chunks]
    _record(axis, "all_to_all", sum(nbytes(c) for c in chunks))
    if not is_meta(group):
        import torch.distributed as dist
        dist.all_to_all(got, chunks, group=group)
    return got


def all_reduce(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """The sum over the group, in place."""
    _record(axis, "all_reduce", nbytes(x))
    if not is_meta(group):
        import torch.distributed as dist
        dist.all_reduce(x, group=group)
    return x


def gather(x: torch.Tensor, out: Optional[List[torch.Tensor]], dst: int,
           group, axis: str) -> None:
    """Every rank's ``x`` into ``out`` on group rank ``dst``."""
    _record(axis, "gather", sum(map(nbytes, out)) if out else nbytes(x))
    if not is_meta(group):
        import torch.distributed as dist
        dist.gather(x, out, dst=global_rank(group, dst), group=group)


def scatter(out: torch.Tensor, parts: Optional[List[torch.Tensor]],
            src: int, group, axis: str) -> torch.Tensor:
    """Group rank r's part of ``parts`` (given on ``src``) into ``out``."""
    _record(axis, "scatter", sum(map(nbytes, parts)) if parts
            else nbytes(out))
    if not is_meta(group):
        import torch.distributed as dist
        dist.scatter(out, parts, src=global_rank(group, src), group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group, axis: str) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank, in place."""
    _record(axis, "broadcast", nbytes(t))
    if not is_meta(group):
        import torch.distributed as dist
        dist.broadcast(t, global_rank(group, src), group=group)
    return t


def isend(x: torch.Tensor, dst: int, group, axis: str):
    _record(axis, "send", nbytes(x))
    if is_meta(group):
        return _Done()
    import torch.distributed as dist
    return dist.isend(x, global_rank(group, dst), group=group)


def recv(buf: torch.Tensor, src: int, group, axis: str) -> torch.Tensor:
    _record(axis, "recv", nbytes(buf))
    if not is_meta(group):
        import torch.distributed as dist
        dist.irecv(buf, global_rank(group, src), group=group).wait()
    return buf
