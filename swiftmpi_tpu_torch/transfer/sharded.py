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

With ``count_traffic`` a pull books its valid requests as
``routed_rows`` (the pull interpreter books the pull ledger) and a push
books them as ``routed_rows`` and one exchange of sparse rows, the span
family's counts column included, exactly where ``TpuTransfer`` books
them; :meth:`ShardedTransfer.traffic` adds ``overflow_dropped``.

The window push (``Transfer.push_window``, ``[cluster] push_window: W``)
prices every W > 1 window and runs its plan over three primitives, as
``TpuTransfer`` does.  The flat ``(W * B,)`` window splits into the n
ranks' contiguous slices of ``W * B / n`` rows (a slice spans steps), and
buckets hold ``C = W * B / n`` slots (or ``bucket_capacity``):

* ``_prim_window_dedup``, the per-rank dedup pre-pass: each rank folds
  the repeats within its own slice into their first position
  (``api.window_dedup``: a scatter-min plane per rank, the grads and
  counts summed by the scatter-add kernel, every rank in one launch a
  family); repeats across ranks still sum at the owner.
* ``_prim_window_exchange``: the deduplicated rows through :meth:`push`,
  their counts riding as a span family's when the mean needs them.
* ``_push_window_dense``, the dense rung: JAX scatters each rank's slice
  into a capacity-shaped plane and reduce-scatters it onto the owners
  (``psum_scatter``).  With the ranks on one card, one scatter-add
  launch of every window row onto the global ``(n * cap, W)`` plane is
  both, its counts from the same launch; each shard's tile is then a
  slice of the plane, and the AdaGrad kernel applies it over the block
  of shards with the mean's reciprocal.

The wire stack's primitives on this backend:

* ``_prim_sparse_allreduce`` is ``_push_window_dense`` bit for bit: JAX's
  tiled reduce-scatter already lands each summed slice on its owner, so a
  sharded target needs no all-gather; only the ledger's model differs
  (the interpreter books the touched rows).
* ``_prim_ef_drain`` is the base class's :func:`~swiftmpi_tpu_torch.
  transfer.api.ef_quantize_window` over the global ``(n * cap, d)`` view
  of each ``@ef`` plane (:meth:`_side_plane`: the device's block of
  shards, no copy).
* the ``@rowver`` plane is one more int32 field of a routed pull (the
  gather kernel's int32 form, the ring's int32 words), and every push
  stamps the rows its owners received, each shard with its own max + 1
  (JAX's max runs over the local shard inside ``shard_map``): the routed
  push from the first family's scatter-add counts, the dense rung from
  the window plane's counts.

The data axis (JAX ``dp_axis``): in a run of ``dp`` processes each
process holds a full replica over its own n shard ranks (the layout's
``dp``), routes its own batch over the shard axis as above (B5 within
the process), and the owners' sums are reconciled across the processes
before the apply, as ``TpuTransfer._push`` does, with the same static
crossover ``sparse_dcn = dp * n * C < cap_per_shard // 2``.  Sparse: the
owners' received (row, grad) pairs, folded per row in each process (B3),
cross the processes and are summed per row in process order
(``Transfer._dp_reconcile_rows``), then land on each owner's plane (B3,
distinct rows); dense: each owner's ``(cap, d)`` sums, the mean's counts
and the ``@rowver`` touched counts are summed over the processes in
process order (``Transfer._dp_psum``; JAX's psums of ``acc``, the counts
and ``touched``).  One exchange a push through B5's cross-process form
(``kernels.ring.ProcessRing``), booked as ``psum_bytes``.  Every replica
applies the same bits.  The window push runs on the same reconciles:
each process deduplicates its own window, the exchange is the push
above, and the dense rung's tiles, counts plane and touched counts are
summed over the processes before the apply (JAX's
``_build_push_window_dense`` psums over ``dp_axis``).  The overflow count is JAX's, summed over both
axes: each process's device counts are summed over the processes (over
gloo, in process order) when :meth:`ShardedTransfer.overflow_count` reads
them, so under ``dp > 1`` every process reads it at the same point, as
``Word2Vec.train`` does once the run is done.

``[cluster] data_plane`` picks the exchange's route once, at
construction (``ops.calibration.route``, logged once): ``auto`` and
``pallas`` run B5; ``xla`` runs the JAX package's library route, each
round as the stacked ranks' transpose (``x.transpose(0, 1).contiguous()``,
the same bits as B5); ``auto`` takes that route only on a current
verdict that the library is at least 10% faster than a correct kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from swiftmpi_tpu_torch.kernels.gather import masked_gather
from swiftmpi_tpu_torch.kernels.ring import (ring_exchange,
                                             ring_exchange_plain,
                                             ring_exchange_stacked)
from swiftmpi_tpu_torch.kernels.scatter import masked_scatter_add
from swiftmpi_tpu_torch.ops.calibration import DATA_PLANE_MODES, route
from swiftmpi_tpu_torch.parameter.sparse_table import ROWVER_KEY, shard_block
from swiftmpi_tpu_torch.transfer.api import (Transfer, bump_row_versions,
                                             grad_row_bytes, window_dedup)

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

        ``data_plane``: ``pallas`` runs the ring-exchange kernel (B5),
        ``xla`` the library exchange (the stacked ranks' transpose),
        ``auto`` the kernel unless the verdict store says otherwise
        (``ops.calibration``); :attr:`exchange_route` names the route."""
        super().__init__()
        if data_plane not in DATA_PLANE_MODES:
            raise ValueError(f"data_plane must be one of "
                             f"{DATA_PLANE_MODES}, got {data_plane!r}")
        self.mesh = mesh
        self.n = int(mesh.n)
        self.data_plane = data_plane
        #: ``"kernel"`` (B5) or ``"library"``: the in-process exchange's
        #: route for this transfer's life
        self.exchange_route = route(data_plane, "ring_push",
                                    mesh.devices[0])
        self.bucket_capacity = bucket_capacity
        self.debug_overflow = debug_overflow
        #: an optional ``utils.timers.Metrics``: :meth:`overflow_count` and
        #: :meth:`routed_rows` mirror their totals into it as gauges
        self.metrics = None
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
                # fold on the device: a step never reads the host here
                self._overflow_pending = [
                    torch.stack(self._overflow_pending).sum()]
            return
        c = self._over_processes(int(count))
        self._overflow_total += c
        if c:
            raise RuntimeError(
                f"ShardedTransfer.{op}: {c} request(s) overflowed "
                f"bucket_capacity={self.bucket_capacity} and were DROPPED "
                "— raise bucket_capacity (or leave it unset for the "
                "overflow-free default)")

    def _over_processes(self, count: int) -> int:
        """``count`` summed over the data axis (JAX psums the overflow
        over both axes); a collective under ``dp > 1``."""
        if self.dp <= 1:
            return count
        from swiftmpi_tpu_torch.parallel.collectives import host_psum
        return int(host_psum([count])[0])

    def overflow_count(self) -> int:
        """Total requests dropped by bucket overflow since construction,
        in every process of the data axis; 0 when no capacity is set
        (overflow impossible by construction)."""
        pending, self._overflow_pending = self._overflow_pending, []
        local = int(torch.stack(pending).sum()) if pending else 0
        self._overflow_total += self._over_processes(local)
        if self.metrics is not None:
            self.metrics.set("transfer_overflow_dropped",
                             self._overflow_total)
        return self._overflow_total

    # -- traffic accounting ------------------------------------------------
    def _record_routed(self, rows) -> None:
        self._book(rows, routed_rows=rows)

    def routed_rows(self) -> int:
        """Total rows routed through the ring exchange since construction
        (counted while ``count_traffic`` is set)."""
        total = self._count("routed_rows")
        if self.metrics is not None:
            self.metrics.set("transfer_routed_rows", total)
        return total

    _mirror_always = ("overflow_dropped",)

    def _own_totals(self) -> Dict[str, int]:
        out = super()._own_totals()
        out["overflow_dropped"] = self.overflow_count()
        return out

    def traffic(self) -> Dict[str, int]:
        """``routed_rows``, ``hot_rows`` (0 here), ``psum_bytes`` (the
        bytes sent to other processes), ``overflow_dropped`` and the wire ledger (``Transfer.traffic``),
        the JAX ``TpuTransfer.traffic``'s keys."""
        out = {"routed_rows": self.routed_rows(), "hot_rows": 0,
               "psum_bytes": self._count("psum_bytes"),
               "overflow_dropped": self.overflow_count()}
        out.update(self.wire_traffic())
        return out

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
        library = self.exchange_route == "library"
        if library and len(groups) == 1:
            # the JAX package's all_to_all of the ranks of one device
            return [per_group[0].transpose(0, 1).contiguous()]
        if len(groups) > 1:
            by_rank = self._by_rank(groups, per_group)
            got = (ring_exchange_plain(by_rank) if library
                   else ring_exchange(by_rank))
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
        if self.count_traffic:
            self._record_routed((slots >= 0).sum())
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
             counts=None, _wire=None):
        """Route ``(slot, grad)`` pairs to their owners, sum them per
        owner row (``mean``: divide by the contribution counts) and apply
        the access rule to every shard in place.

        The owners of one device sum each family in one scatter-add launch
        over all their ranks; a mean push takes its counts from the first
        family's launch.  ``counts`` (non-None) marks a position-indexed
        span family: the per-row contribution counts ride the routing as a
        synthetic width-1 grad field, so ``mean`` divides by the data counts
        rather than one per request, as ``push_span`` of the single-device
        backend does.  ``_wire`` (the window's ``(row_bytes,
        base_bytes)``) replaces the ledger's sparse row model."""
        n = self.n
        with_counts = counts is not None
        if self.count_traffic:
            rows = (slots >= 0).sum()
            self._record_routed(rows)
            # the counts column rides as a 4-byte column of span rows
            if _wire is not None:
                self._record_exchange(rows, _wire[0], base_bytes=_wire[1])
            else:
                self._record_exchange(
                    rows, grad_row_bytes(grads, with_counts=with_counts))
        self.push_paths[f"{','.join(grads)}:"
                        f"{'routed_span' if with_counts else 'routed'}"] += 1
        grads = dict(grads)
        if with_counts:
            grads[_COUNTS] = counts.to(torch.float32).reshape(-1, 1)
        groups, C, cap = self._route(state, slots)
        Bl = slots.shape[0] // n
        # received rows per owner; padding is dropped by the scatter
        rows, ok = self._requests(groups)
        # per group: family -> (R, cap, W) sums, the mean's divisor and
        # the received rows' counts (a versioned table stamps them)
        sums = [{} for _ in groups]
        divisor = [None] * len(groups)
        occupied = [None] * len(groups)
        versions = ROWVER_KEY in state
        # the data axis's static crossover (JAX tpu.py): the processes'
        # received pairs while they are fewer than half a shard
        sparse_dp = self.dp > 1 and self.dp * n * C < cap // 2
        received = [{} for _ in groups]
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
            if sparse_dp:
                for k, (g, t) in enumerate(zip(groups, recv)):
                    received[k][f] = t.view(len(g.ranks), -1, width)
                continue
            for k, (g, t) in enumerate(zip(groups, recv)):
                # contribution counts accumulate at the owner from the
                # received requests themselves: no extra exchange
                take = occupied[k] is None and (
                    versions or (mean and not with_counts))
                res = masked_scatter_add(rows[k], ok[k],
                                         t.view(len(g.ranks), -1, width),
                                         cap, counts=take)
                if take:
                    res, occupied[k] = res
                    if mean and not with_counts:
                        divisor[k] = occupied[k].clamp(min=1.0)
                sums[k][f] = res
        for k, g in enumerate(groups):
            if sparse_dp:
                sums[k], occupied[k] = self._reconcile_sparse(
                    rows[k], received[k], cap)
            elif self.dp > 1:
                sums[k], occupied[k] = self._reconcile_dense(
                    sums[k], occupied[k])
            if self.dp > 1 and mean and not with_counts:
                divisor[k] = occupied[k].clamp(min=1.0)
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
            if versions:
                bump_row_versions(self._block(state, ROWVER_KEY, g),
                                  occupied[k] > 0)
        self._record_overflow("push", groups)
        return state

    def _reconcile_sparse(self, rows, received, cap: int):
        """The sparse data-axis reconcile of one device's owners: their
        ``(R, n * C)`` received rows and grads ``{f: (R, n * C, W)}``
        summed per row over the processes in process order, then landed on
        each owner's ``(cap, W)`` plane (B3 over distinct rows; the counts
        of every process's received requests beside them)."""
        R = rows.shape[0]
        first, sums, cnt = self._dp_reconcile_rows(rows, received, None,
                                                   cap)
        names = sorted(sums)
        cat = torch.cat([sums[f] for f in names] + [cnt[..., None]], -1)
        plane = masked_scatter_add(first, first >= 0, cat.contiguous(), cap)
        out, at = {}, 0
        for f in names:
            w = sums[f].shape[-1]
            out[f] = plane[..., at:at + w]
            at += w
        return out, plane[..., at].reshape(R, cap)

    def _reconcile_dense(self, sums, occupied):
        """The dense data-axis reconcile of one device's owners: every
        family's ``(R, cap, W)`` sums and the received requests' counts
        (when taken) summed over the processes in process order, one
        exchange."""
        names = sorted(sums)
        parts = [sums[f] for f in names]
        if occupied is not None:
            parts.append(occupied)
        summed = self._dp_psum(parts)
        return (dict(zip(names, summed[:len(names)])),
                summed[-1] if occupied is not None else None)

    def push_span(self, state, slots, grads, counts, access,
                  mean: bool = False):
        """Span push over the same routing; see :meth:`push` ``counts``."""
        return self.push(state, slots, grads, access, mean=mean,
                         counts=counts)

    # -- the window primitives ----------------------------------------------
    def _rank_slices(self, flat: torch.Tensor) -> int:
        """Rows of each rank's contiguous slice of a flat window."""
        if flat.dim() != 1 or flat.shape[0] % self.n:
            raise ValueError(
                f"a window of {tuple(flat.shape)} slots does not split into "
                f"{self.n} equal rank slices")
        return flat.shape[0] // self.n

    def _prim_window_dedup(self, flat, fgrads, fcounts, capacity):
        """Each rank's slice deduplicated on its own (the JAX package's
        per-device pre-pass), every rank in one pass on the window's
        device: worker-side work, like the bucketing."""
        n, L = self.n, self._rank_slices(flat)
        ded, dgrads, dcounts = window_dedup(
            flat.view(n, L),
            {f: g.view(n, L, g.shape[-1]) for f, g in fgrads.items()},
            None if fcounts is None else fcounts.view(n, L), capacity)
        return (ded.reshape(-1),
                {f: g.reshape(n * L, -1) for f, g in dgrads.items()},
                dcounts.reshape(-1))

    def _prim_window_exchange(self, state, ded_slots, ded_grads, ded_counts,
                              access, mean, need_counts, wire):
        """The deduplicated window through the bucket routing once."""
        return self.push(state, ded_slots, ded_grads, access, mean=mean,
                         counts=ded_counts if need_counts else None,
                         _wire=wire)

    def _push_window_dense(self, state, flat, fgrads, access, mean,
                           fcounts):
        """The dense rung: every row onto the global ``(n * cap, W)``
        plane, one scatter-add launch a family (the counts of a mean
        from the first family's launch, or from a width-1 launch of the
        span counts), then each device's block of shards updated from
        its tiles of the plane, the mean's reciprocal inside the AdaGrad
        launch.  Untouched rows see a zero gradient, as in JAX."""
        self._rank_slices(flat)
        n = self.n
        cap = next(iter(state.values()))[0].shape[0]
        capacity = n * cap
        valid = flat >= 0
        self.push_paths[f"{','.join(sorted(fgrads))}:window_dense"] += 1
        versions = ROWVER_KEY in state
        planes, occ = {}, None
        for f in sorted(fgrads):
            take = occ is None and (versions or (mean and fcounts is None))
            res = masked_scatter_add(flat, valid, fgrads[f].contiguous(),
                                     capacity, counts=take)
            if take:
                res, occ = res
            planes[f] = res.view(n, cap, -1)
        cnt = occ
        if mean and fcounts is not None:
            cnt = masked_scatter_add(flat, valid, fcounts.to(torch.float32)
                                     .reshape(-1, 1).contiguous(),
                                     capacity)[:, 0]
        if self.dp > 1:
            # JAX's psums of the tiles, the counts plane and ``touched``
            # over the data axis: summed in process order, one exchange
            names = sorted(planes)
            own_cnt = cnt is not None and cnt is not occ
            summed = self._dp_psum(
                [planes[f] for f in names]
                + [t for t in (occ, cnt if own_cnt else None)
                   if t is not None])
            planes = dict(zip(names, summed))
            k = len(names)
            if occ is not None:
                occ, k = summed[k], k + 1
            cnt = summed[k] if own_cnt else occ
        inv = (1.0 / cnt.clamp(min=1.0)).view(n, cap) if mean else None
        for g in self._groups:
            dev, ranks = g
            tiles = {f: self._take(p, ranks).to(dev)
                     for f, p in planes.items()}
            access.apply_push(
                {f: shard_block([state[f][r] for r in ranks])
                 for f in access.touched_fields(tiles)}, tiles,
                mul=None if inv is None else self._take(inv, ranks).to(dev))
            if versions:
                bump_row_versions(
                    shard_block([state[ROWVER_KEY][r] for r in ranks]),
                    self._take(occ.view(n, cap), ranks).to(dev) > 0)
        return state

    def _prim_sparse_allreduce(self, state, flat, fgrads, access, mean,
                               fcounts):
        """The dense rung's exchange already is the balanced reduce-scatter
        onto the owners: the same computation, bit for bit; only the
        ledger's model (booked by the interpreter) differs."""
        return self._push_window_dense(state, flat, fgrads, access, mean,
                                       fcounts)

    def _trace_shard_args(self, capacity: int) -> dict:
        """Window trace records carry the per-destination row split: this
        backend owns ``slot // (capacity / n)``."""
        return {"cap_per_shard": capacity // self.n, "n_shards": self.n}

    def _side_plane(self, state, key):
        """The global ``(n * cap, d)`` rows of a tail-shaped side plane as
        one tensor that updates the shards in place: a view of the block
        of shards when every rank is on one device."""
        if len(self._groups) != 1:
            raise NotImplementedError(
                "error feedback over shards on several devices (ROADMAP "
                "A11d); the port keeps every rank on one device")
        block = shard_block(state[key])
        return block.view(-1, block.shape[-1])
