"""Sharded transfer backend: explicit request/response routing between the
n ranks of the parameter server (counterpart of
``swiftmpi_tpu/transfer/tpu.py``; keeps ``name = "tpu"`` so ``[cluster]
transfer: tpu`` selects it).

Every rank plays both roles, worker (it holds a contiguous slice of the
batch) and server (it holds a table shard), like every reference MPI rank
(reference cluster.h:65-71).  One pull is:

  1. each rank buckets its slot requests by owning shard
     (``_bucketize``; arrange_local_vals, global_pull_access.h:46-60)
  2. the ``(n, C)`` request buckets cross the ring exchange
     (``kernels/ring.py``; Transfer::send + main_loop recv)
  3. owners gather rows from their own shard (the gather kernel)
  4. the ``(n, C, d)`` rows cross the ring back and are unpermuted to
     request order.

A push routes (slot, grad) pairs the same way; owners sum what they
receive into a ``(cap_per_shard, W)`` accumulator with the scatter-add
kernel, invalid rows dropped (the owners of one device in one launch per
family, a mean push's counts from the same launch), and apply the access
method once per row (the AdaGrad kernel over the device's block of
shards, one launch per family, the mean's reciprocal applied inside it;
untouched rows see zero gradient).
Shapes are static: request buckets hold ``C`` slots per destination, the
whole local slice unless ``bucket_capacity`` cuts it, with ``-1`` padding.
A bfloat16 table (``[server] dtype: bfloat16``) pulls bfloat16 rows: the
owners gather them from their bfloat16 block and they cross the ring as
4-byte words, bits unchanged; grads are float32 and push as with a
float32 table, into the AdaGrad kernel's mixed form.

Where the JAX package runs one SPMD program over a device mesh, the port
walks the ranks of a :class:`~swiftmpi_tpu_torch.cluster.mesh.RankLayout`.
The worker-side bookkeeping of the ranks that share a device (bucketing
their batch slices, laying grads out in buckets, restoring request order)
runs as one batched pass per device, to keep the launch count down; so
do every ring exchange (one send launch and one wait launch per device)
and the owner-side kernels: the gather, the scatter-add (over the
device's ``(R, n * C)`` received rows, slices of one exchange output) and
AdaGrad each take the device's ``(R, cap_per_shard, d)`` block of shards
(``sparse_table.shard_block``) in one launch, rank ``r`` on slice ``r``
only.  The table state is ``{field: [shard tensors]}``
(``parameter/sparse_table.py``).

Not ported: the data axis across processes (``dp_axis``, the sparse DCN
reconcile; ROADMAP A11), the window primitives, ``@rowver`` stamping and
the traffic ledger (ROADMAP A12), and ``[cluster] data_plane: xla``, the
library route of the exchange (ROADMAP A16).
"""

from __future__ import annotations

from typing import Optional

import torch

from swiftmpi_tpu_torch.kernels.gather import masked_gather
from swiftmpi_tpu_torch.kernels.ring import (ring_exchange,
                                             ring_exchange_stacked)
from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
from swiftmpi_tpu_torch.parameter.sparse_table import shard_block
from swiftmpi_tpu_torch.transfer.api import Transfer

_COUNTS = "__counts__"


def _bucketize(slots_l: torch.Tensor, n: int, cap_per_shard: int, C: int):
    """Group slot requests by owner shard into ``(n, C)`` matrices, for one
    rank (``slots_l`` of shape ``(B,)``) or for R ranks of one device at
    once (``(R, B)``: every result gains a leading R).

    Returns ``(req, order, so, idx_in_bucket)``: ``req[o, j]`` is the
    owner-local row of the rank's j-th request to shard ``o`` (``-1``
    padding); ``order`` sorts the requests by owner (stably), ``so`` are
    the sorted owners (``n`` for invalid requests, which sort last) and
    ``idx_in_bucket`` each sorted request's position in its bucket, which
    together restore request order on the way back.  Requests past ``C``
    in a bucket are dropped.  Each rank's ``req`` is contiguous.
    """
    if slots_l.dim() == 1:
        return tuple(t[0] for t in _bucketize(slots_l[None], n,
                                              cap_per_shard, C))
    (R, B), dev = slots_l.shape, slots_l.device
    valid = slots_l >= 0
    owner = torch.where(valid, slots_l // cap_per_shard, n)
    so, order = torch.sort(owner, dim=1, stable=True)
    local_row = torch.where(valid, slots_l % cap_per_shard, 0).gather(
        1, order)
    bounds = torch.arange(n + 1, dtype=so.dtype, device=dev).expand(
        R, n + 1).contiguous()
    group_start = torch.searchsorted(so, bounds)
    idx = torch.arange(B, device=dev) - group_start.gather(
        1, so.clamp(0, n).long())
    in_bounds = (so < n) & (idx < C)
    # row n of each rank takes what is dropped
    req = torch.full((R, n + 1, C), -1, dtype=torch.int32, device=dev)
    req[_rank_index(R, dev), torch.where(in_bounds, so, n).long(),
        torch.where(in_bounds, idx, 0)] = local_row.to(torch.int32)
    return req[:, :n], order, so, idx


def _rank_index(R: int, device) -> torch.Tensor:
    """``(R, 1)`` row index that pairs each rank with its own columns in
    an advanced-indexing expression."""
    return torch.arange(R, device=device)[:, None]


class _Group:
    """The routing of the ranks that share one device, from one batched
    ``_bucketize``: ``req`` ``(R, n, C)``, ``order``/``so``/``idx``
    ``(R, B_local)``."""

    def __init__(self, device, ranks, req, order, so, idx):
        self.device, self.ranks = device, ranks
        self.req, self.order, self.so, self.idx = req, order, so, idx


class ShardedTransfer(Transfer):
    name = "tpu"

    def __init__(self, mesh, bucket_capacity: Optional[int] = None,
                 debug_overflow: bool = False, data_plane: str = "auto"):
        """``mesh``: the rank layout (``cluster.mesh.ps_mesh``).

        ``bucket_capacity``: request slots per destination; the default is
        the whole local slice (no overflow possible).  Smaller values cut
        the exchanged volume about in proportion but drop the requests
        that overflow a bucket, which is safe only when keys are known to
        spread.  With a capacity set every pull and push counts the
        dropped requests; :meth:`overflow_count` reads the running total.
        ``debug_overflow`` checks the count on every call and raises:
        slow (one host read per call), but it turns silent corruption
        into an immediate failure.

        ``data_plane``: ``auto`` and ``pallas`` run the ring-exchange
        kernel; ``xla``, the JAX package's library exchange, is not
        ported."""
        super().__init__()
        if data_plane not in ("auto", "pallas", "xla"):
            raise ValueError(f"data_plane must be one of ('auto', 'pallas', "
                             f"'xla'), got {data_plane!r}")
        if data_plane == "xla":
            raise NotImplementedError(
                "[cluster] data_plane: xla with transfer: tpu (the library "
                "exchange and the device-kind verdict store) is not ported "
                "(ROADMAP A16); the port routes every exchange through the "
                "ring kernel")
        self.mesh = mesh
        self.n = int(mesh.n)
        self.data_plane = data_plane
        self.bucket_capacity = bucket_capacity
        self.debug_overflow = debug_overflow
        self._overflow_total = 0
        self._overflow_pending: list = []      # device scalars, read lazily
        #: (device, its ranks): the ranks of one device are routed in one
        #: batched pass, and their table shards are one block
        self._groups = [(dev, list(ranks))
                        for dev, ranks in mesh.device_groups]

    # -- overflow accounting ----------------------------------------------
    def _record_overflow(self, op: str, groups) -> None:
        """Queue this call's count of valid requests dropped by their
        bucket; only :meth:`overflow_count` (or ``debug_overflow``) reads
        it to the host."""
        if self.bucket_capacity is None:
            return
        C = self.bucket_capacity
        count = torch.stack([
            ((g.so < self.n) & (g.idx >= C)).sum().to(self.mesh.devices[0])
            for g in groups]).sum()
        if not self.debug_overflow:
            self._overflow_pending.append(count)
            if len(self._overflow_pending) >= 1024:
                self.overflow_count()
            return
        c = int(count)
        self._overflow_total += c
        if c:
            raise RuntimeError(
                f"ShardedTransfer.{op}: {c} request(s) overflowed "
                f"bucket_capacity={self.bucket_capacity} and were DROPPED "
                "— raise bucket_capacity (or leave it unset for the "
                "overflow-free default)")

    def overflow_count(self) -> int:
        """Total requests dropped by bucket overflow since construction;
        0 when no capacity is set (overflow impossible by construction)."""
        pending, self._overflow_pending = self._overflow_pending, []
        if pending:
            self._overflow_total += int(torch.stack(pending).sum())
        return self._overflow_total

    # -- routing -----------------------------------------------------------
    def _route(self, state, slots: torch.Tensor):
        """Split the batch's slots into the n ranks' contiguous slices and
        bucket them, the ranks of one device in one pass:
        ``(groups, C, cap_per_shard)``."""
        n = self.n
        B = slots.shape[0]
        if slots.dim() != 1 or B % n:
            raise ValueError(
                f"a batch of {tuple(slots.shape)} slots does not split into "
                f"{n} equal rank slices")
        cap_per_shard = next(iter(state.values()))[0].shape[0]
        C = self.bucket_capacity or B // n
        per_rank = slots.to(torch.int32).view(n, B // n)
        groups = []
        for dev, ranks in self._groups:
            mine = self._take(per_rank, ranks).to(dev)
            groups.append(_Group(dev, ranks, *_bucketize(
                mine, n, cap_per_shard, C)))
        return groups, C, cap_per_shard

    def _take(self, per_rank: torch.Tensor, ranks) -> torch.Tensor:
        """The slices of ``ranks`` out of an ``(n, ...)`` per-rank view."""
        if len(ranks) == self.n:
            return per_rank
        return per_rank[torch.as_tensor(ranks, device=per_rank.device)]

    def _exchange(self, groups, per_group):
        """The ring exchange of the ranks' operands, given per group as one
        ``(R, n, ...)`` tensor whose rank slices are contiguous; each group
        gets its ranks' results back as one ``(R, n, ...)`` tensor.  The
        ranks of one device exchange in one send launch."""
        if len(groups) > 1:
            got = ring_exchange(self._by_rank(groups, per_group))
            return [torch.stack([got[r] for r in g.ranks]) for g in groups]
        return [ring_exchange_stacked(per_group[0])]

    def _requests(self, groups):
        """Exchange the request buckets: per group, the ``(R, n * C)``
        owner-local rows its ranks received as owners (``-1`` padding) and
        their validity."""
        got = self._exchange(groups, [g.req for g in groups])
        rows = [t.view(len(g.ranks), -1) for g, t in zip(groups, got)]
        return rows, [t >= 0 for t in rows]

    @staticmethod
    def _block(state, f, g):
        """Field ``f``'s ``(R, cap, d)`` block of the group's shards."""
        return shard_block([state[f][r] for r in g.ranks])

    def _by_rank(self, groups, per_group):
        """Per-rank list of the slices of per-group ``(R, ...)`` tensors."""
        out = [None] * self.n
        for g, t in zip(groups, per_group):
            for i, r in enumerate(g.ranks):
                out[r] = t[i]
        return out

    # -- pull --------------------------------------------------------------
    def _prim_pull(self, state, slots, fields):
        n = self.n
        groups, C, _ = self._route(state, slots)
        got, ok = self._requests(groups)
        out = {}
        for f in fields:
            d = state[f][0].shape[1]
            # owners: rows of their own shard, zero where the request is
            # padding, straight into the group's operand of the exchange;
            # one launch for the group's block of shards
            rows = []
            for g, gr, gk in zip(groups, got, ok):
                buf = torch.empty((len(g.ranks), n * C, d),
                                  dtype=state[f][0].dtype, device=g.device)
                masked_gather(self._block(state, f, g), gr, gk, out=buf)
                rows.append(buf.view(len(g.ranks), n, C, d))
            resp = self._exchange(groups, rows)
            res = torch.empty((n, slots.shape[0] // n, d),
                              dtype=rows[0].dtype, device=slots.device)
            for g, mine in zip(groups, resp):
                rank = _rank_index(len(g.ranks), g.device)
                hit = (g.so < n) & (g.idx < C)
                vals = mine[rank, g.so.clamp(0, n - 1).long(),
                            g.idx.clamp(0, C - 1)]
                vals = torch.where(hit[..., None], vals, 0)
                part = torch.empty_like(vals)
                part[rank, g.order] = vals         # back to request order
                if len(g.ranks) == n:
                    res = part.to(slots.device)
                else:
                    res[torch.as_tensor(g.ranks, device=res.device)] = \
                        part.to(slots.device)
            out[f] = res.view(-1, d)
        self._record_overflow("pull", groups)
        return out

    # -- push --------------------------------------------------------------
    def push(self, state, slots, grads, access, mean: bool = False,
             counts=None):
        """Route ``(slot, grad)`` pairs to their owners, sum them per
        owner row (``mean``: divide by the contribution counts) and apply
        the access rule to every shard in place.

        The owners of one device sum each family in one scatter-add launch
        over all their ranks; a mean push takes its counts from the first
        family's launch.  ``counts`` (non-None) marks a position-indexed
        span family: the per-row contribution counts ride the routing as a
        synthetic width-1 grad field, so ``mean`` divides by the data counts
        rather than one per request, as ``push_span`` of the single-device
        backend does."""
        n = self.n
        with_counts = counts is not None
        self.push_paths[f"{','.join(grads)}:"
                        f"{'routed_span' if with_counts else 'routed'}"] += 1
        grads = dict(grads)
        if with_counts:
            grads[_COUNTS] = counts.to(torch.float32).reshape(-1, 1)
        groups, C, cap = self._route(state, slots)
        Bl = slots.shape[0] // n
        # received rows per owner; padding is dropped by the scatter
        rows, ok = self._requests(groups)
        # per group: family -> (R, cap, W) sums, and the mean's divisor
        sums = [{} for _ in groups]
        divisor = [None] * len(groups)
        for f in sorted(grads):
            g_all = grads[f]
            width = g_all.shape[1]
            per_rank = g_all.view(n, Bl, width)
            buckets = []
            for g in groups:
                R = len(g.ranks)
                rank = _rank_index(R, g.device)
                # the ranks' grads in the (n, C) layout of their requests;
                # row n of each rank takes what is dropped
                bucket = torch.zeros((R, n + 1, C, width), dtype=g_all.dtype,
                                     device=g.device)
                hit = (g.so < n) & (g.idx < C)
                mine = self._take(per_rank, g.ranks).to(g.device)
                bucket[rank, torch.where(hit, g.so, n).long(),
                       g.idx.clamp(0, C - 1)] = mine[rank, g.order]
                buckets.append(bucket[:, :n])
            recv = self._exchange(groups, buckets)
            for k, (g, t) in enumerate(zip(groups, recv)):
                # contribution counts accumulate at the owner from the
                # received requests themselves: no extra exchange
                take = mean and not with_counts and divisor[k] is None
                res = masked_scatter_add(rows[k], ok[k],
                                         t.view(len(g.ranks), -1, width),
                                         cap, counts=take)
                if take:
                    res, cnt = res
                    divisor[k] = cnt.clamp(min=1.0)
                sums[k][f] = res
        for k, g in enumerate(groups):
            dense = sums[k]
            if with_counts:
                # span families: the data counts summed at the owner like
                # any grad
                csum = dense.pop(_COUNTS)
                if mean:
                    divisor[k] = csum[..., 0].clamp(min=1.0)
            # the mean multiplies by the reciprocal (JAX tpu.py), inside
            # the AdaGrad launch: one per family over the group's block
            inv = 1.0 / divisor[k] if mean else None
            access.apply_push(
                {f: self._block(state, f, g)
                 for f in access.touched_fields(dense)}, dense, mul=inv)
        self._record_overflow("push", groups)
        return state

    def push_span(self, state, slots, grads, counts, access,
                  mean: bool = False):
        """Span push over the same routing; see :meth:`push` ``counts``."""
        return self.push(state, slots, grads, access, mean=mean,
                         counts=counts)

    # -- not ported ----------------------------------------------------------
    def push_window(self, *args, **kwargs):
        raise NotImplementedError(
            "the window-coalesced push of the sharded transfer is not "
            "ported yet (ROADMAP A12)")

    def traffic(self):
        raise NotImplementedError(
            "the traffic ledger of the sharded transfer is not ported yet "
            "(ROADMAP A12)")
