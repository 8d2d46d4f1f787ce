"""The port's collectives on tensors, over one axis of a mesh.

Every sum of floats across ranks is a gather of every rank's part, then a
sum in rank order, ((p0 + p1) + p2) + ...: the result is then the same bits
on gloo and on NCCL, on every rank and from run to run.  NCCL's
`all_reduce` chooses its own order (rings, trees) and promises no such
thing across world sizes; the port's rule is no float atomics, bitwise run
to run.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

# torch 2.13 renamed all_gather_into_tensor (the older name warns there)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(D, *t.shape): every rank's `t` along `axis`, by coordinate.  Each
    rank's tensor has one shape and dtype (the padded wire format)."""
    D = mesh.shape[axis]
    t = t.contiguous()
    out = torch.empty((D * t.numel(),), dtype=t.dtype, device=t.device)
    _all_gather(out, t.reshape(-1), group=mesh.group(axis))
    return out.view(D, *t.shape)


def gather_ints(values: Sequence[int], mesh, axis: str):
    """Every rank's host integers along `axis`, as a (D, len) nested list
    (one small collective and one host read)."""
    t = torch.tensor(list(values), dtype=torch.int64, device=mesh.device)
    return gather(t, mesh, axis).tolist()


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts[0] + parts[1] + ..., left to right, along the leading axis."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


def sum_across(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's `t` along `axis`, in rank order, on every
    rank (all_gather, then `ordered_sum`)."""
    return ordered_sum(gather(t, mesh, axis))


def exchange(chunks: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """all_to_all along `axis`: chunks (D, ...) of this rank, chunk j to the
    rank of coordinate j; returns (D, ...), chunk j from coordinate j."""
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mesh.group(axis))
    return out


def reduce_scatter(chunks: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunk `index(axis)` of the sum of every rank's `chunks` (D, ...),
    summed in rank order: the chunks each rank keeps are exchanged
    (all_to_all, 1/D of an all_gather's bytes), then added as
    `sum_across` adds, so the bits are the same."""
    return ordered_sum(exchange(chunks, mesh, axis))


def permute(tensors: Tuple[torch.Tensor, ...], mesh, axis: str,
            perm: Sequence[Tuple[int, int]]):
    """JAX's `ppermute` of this rank's `tensors` along `axis`: each (src,
    dst) pair of coordinates sends src's tensors to dst.  Returns the
    tensors received, zeros where no pair names this rank as dst.  A pair
    (i, i) is a local copy: gloo has no pair to itself (it raises "Pair is
    not connected"), and a copy is what the send would deliver.  The sends
    and receives go in one `batch_isend_irecv`; returns (received,
    pending), and the caller passes `pending` to `wait` before reading
    (it also holds the ops, so the sent tensors live until then)."""
    my = mesh.index(axis)
    ranks = mesh.ranks(axis)
    out = tuple(torch.zeros_like(t) for t in tensors)
    ops = []
    for src, dst in perm:
        if src == dst == my:
            for o, t in zip(out, tensors):
                o.copy_(t)
        elif src == my:
            ops += [dist.P2POp(dist.isend, t.contiguous(), ranks[dst],
                               group=mesh.group(axis)) for t in tensors]
        elif dst == my:
            ops += [dist.P2POp(dist.irecv, o, ranks[src],
                               group=mesh.group(axis)) for o in out]
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return out, (reqs, ops)


def wait(pending) -> None:
    for r in pending[0]:
        r.wait()


def ring(tensors: Tuple[torch.Tensor, ...], mesh, axis: str):
    """JAX's ring over `axis`: yields this rank's `tensors` D times; after
    s hops along (i -> i+1) they are coordinate (my - s) mod D's.  Each hop
    is started before the tensors in hand are yielded and waited on after,
    so the transfer overlaps the caller's work on them.  The last hop of
    JAX's loop, which only brings each block home, is skipped: at D = 1 the
    ring makes no hop, and no rank ever sends to itself."""
    D = mesh.shape[axis]
    perm = [(i, (i + 1) % D) for i in range(D)]
    for s in range(D):
        if s < D - 1:
            nxt, pending = permute(tensors, mesh, axis, perm)
        yield tensors
        if s < D - 1:
            wait(pending)
            tensors = nxt
