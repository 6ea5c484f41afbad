"""Collective matmul: overlap tensor-parallel communication with compute
(port of ``repro.distributed.collective_matmul``).

A plain all-gather -> matmul runs the two in sequence; the classic
"collective matmul" (Wang et al., ASPLOS'23) decomposes the gather into
ring steps and overlaps each shard's matmul with the next shard's
exchange.  The exchange rides the ring the paper's axis planner assigns,
so the overlap efficiency is the ring quality.

Each function runs on every rank of ``group`` (default: the world) with its
local shards, as JAX's ``shard_map`` body does.  A ring step posts the
exchange with its neighbours (send to rank r + 1, receive from r - 1, mod
n) with ``batch_isend_irecv``, computes the resident block's product, then
waits: JAX's ``ppermute`` overlap.

* ``allgather_matmul(x, w, group)``  — y = allgather(x) @ w, with x this
  rank's block of rows and w replicated; every rank returns all of y.
* ``matmul_reducescatter(x, w, group)`` — y = reducescatter(x @ w) with x
  and w sharded on the contracting dimension; partial products are
  accumulated around the ring, and rank r returns row block r of y, fully
  reduced.

The products are ``torch.matmul``; the sums are the JAX package's, in its
order.  Each exchange is recorded as one ``collective-permute`` into the
active :class:`~repro_torch.analysis.roofline.CollectiveTrace`, since the
point-to-point ops are not functional collectives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.roofline import active_traces


def _ring(group) -> Tuple[int, int, int, int]:
    """(ring size, this rank in the group, global rank of the next, of the
    previous member)."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    nxt, prev = (r + 1) % n, (r - 1) % n
    if group is not None:
        nxt, prev = dist.get_global_rank(group, nxt), dist.get_global_rank(group, prev)
    return n, r, nxt, prev


def _exchange(send: torch.Tensor, nxt: int, prev: int, group) -> Tuple[torch.Tensor, List]:
    """Post: send ``send`` to ``nxt``, receive a tensor like it from
    ``prev``.  Returns (the receive buffer, the requests to wait on)."""
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group),
        dist.P2POp(dist.irecv, recv, prev, group),
    ])
    name = (group if group is not None else dist.group.WORLD).group_name
    for trace in active_traces():
        trace.record("collective-permute", recv.numel() * recv.element_size(), name)
    return recv, reqs


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                     ) -> torch.Tensor:
    """y = (all-gather of x over ``group``) @ w.

    x: (m_shard, k), this rank's rows; w: (k, n) replicated.  Returns y:
    (m_shard * ranks, n), computed so that each ring step's exchange
    overlaps the resident block's product (no monolithic gather).
    """
    n, r, nxt, prev = _ring(group)
    m_shard = x.shape[0]
    blk = x.contiguous()
    out = None
    for i in range(n):
        src = (r - i) % n
        if i + 1 < n:
            incoming, reqs = _exchange(blk, nxt, prev, group)
        y_i = blk @ w
        if out is None:
            out = y_i.new_empty((m_shard * n, y_i.shape[1]))
        out[src * m_shard : (src + 1) * m_shard] = y_i
        if i + 1 < n:
            for req in reqs:
                req.wait()
            blk = incoming
    return out


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                         ) -> torch.Tensor:
    """y = reduce-scatter(x @ w) over ``group``, by rows of the output.

    x: (m, k_shard) and w: (k_shard, n), this rank's shards of the
    contracting dimension.  Returns y: (m / ranks, n), row block ``rank``.
    The accumulator that starts at rank s carries output block s - 1; after
    t hops rank r holds block r - t - 1 and adds its own contribution, so
    after n - 1 hops rank r holds its own block r, fully reduced.  Each
    hop's exchange overlaps the next local product.
    """
    n, r, nxt, prev = _ring(group)
    m_shard = x.shape[0] // n
    rows = lambda b: x[b * m_shard : (b + 1) * m_shard]
    acc = rows((r - 1) % n) @ w
    for t in range(1, n):
        incoming, reqs = _exchange(acc.contiguous(), nxt, prev, group)
        part = rows((r - t - 1) % n) @ w
        for req in reqs:
            req.wait()
        acc = incoming + part
    return acc
