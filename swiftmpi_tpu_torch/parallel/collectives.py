"""Collectives over the data axis (counterpart of ``swiftmpi_tpu/
parallel/collectives.py``).

The JAX package's helpers wrap ``jax.lax`` collectives inside
``shard_map`` bodies.  The port's data axis is the processes of the run
(``cluster/bootstrap.py``), so these act over the process group: a CPU
tensor goes through gloo (the plain version), a CUDA tensor through B5's
cross-process exchange (``kernels.ring.ProcessRing``), never through
gloo.  With one process each is the identity of its JAX counterpart on a
size-1 axis.

Every process must call a collective at the same point with tensors of
one shape and dtype.  :func:`psum` sums in process order, process 0's
part first, so every replica computes the same bits from the same parts
whatever the summation order of each part was.

**Over a rank axis** (the transformer family's ``seq``, ``expert`` and
``stage`` axes, ``cluster.mesh.Mesh``): the n ranks of an axis share one
device, and a collective acts on a tensor stacked over them (leading dim
n, rank ``r``'s local value at ``x[r]``), where JAX's acts inside a
``shard_map`` body.  :func:`ring_permute` is ``torch.roll`` on the rank
dim (JAX's ``ppermute`` is no Pallas kernel); :func:`rank_all_to_all`
is JAX's tiled ``all_to_all`` through B5's stacked exchange
(``kernels.ring.RingExchange``, which launches the kernel for a CUDA
tensor, forward and backward, and runs the plain version for a CPU one);
:func:`rank_reduce_scatter` is JAX's tiled ``reduce_scatter`` through
the same exchange, each rank summing its received blocks in source order;
:func:`rank_psum` and :func:`rank_pmean` reduce the rank dim to the one
value every rank holds.
"""

from __future__ import annotations

import zlib
from typing import List, Sequence, Tuple

import torch

from swiftmpi_tpu_torch.cluster import bootstrap
from swiftmpi_tpu_torch.cluster.mesh import DATA_AXIS
from swiftmpi_tpu_torch.kernels import ring


def _check_axis(axis: str) -> None:
    if axis != DATA_AXIS:
        raise ValueError(f"the port's collectives act over the {DATA_AXIS!r} "
                         f"axis (the processes), got {axis!r}")


def axis_index(axis: str = DATA_AXIS) -> int:
    """This process's position on the data axis."""
    _check_axis(axis)
    return bootstrap.process_index()


def axis_size(axis: str = DATA_AXIS) -> int:
    """The number of processes."""
    _check_axis(axis)
    return bootstrap.process_count()


def all_gather(x: torch.Tensor, axis: str = DATA_AXIS, *,
               tiled: bool = True) -> torch.Tensor:
    """Every process's ``x``, in process order: concatenated along dim 0
    (``tiled``) or stacked on a new leading dim."""
    _check_axis(axis)
    if bootstrap.process_count() == 1:
        return x.clone() if tiled else x.unsqueeze(0).clone()
    got = ring.process_all_gather(x)
    return got.reshape(-1, *x.shape[1:]) if tiled else got


def all_to_all(x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """``x`` ``(dp, C, ...)``: block j goes to process j; block j of the
    result came from process j."""
    _check_axis(axis)
    if bootstrap.process_count() == 1:
        return x.clone()
    return ring.process_all_to_all(x)


def psum_many(xs: Sequence[torch.Tensor],
              axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """:func:`psum` of several tensors on one device, through one
    exchange: their bytes packed into one buffer of 4-byte words (a
    tensor of 2-byte elements, such as bfloat16, padded to a whole word),
    gathered, each part summed in process order in its own dtype."""
    _check_axis(axis)
    xs = list(xs)
    if bootstrap.process_count() == 1 or not xs:
        return [x.clone() for x in xs]
    parts, spans = [], []
    for x in xs:
        if x.element_size() not in (2, 4):
            raise TypeError(f"psum packs 2- and 4-byte elements, got "
                            f"{x.dtype}")
        b = x.detach().reshape(-1).contiguous().view(torch.uint8)
        pad = -b.numel() % 4
        spans.append((b.numel(), pad))
        parts.append(b)
        if pad:
            parts.append(b.new_zeros(pad))
    words = torch.cat(parts).view(torch.int32)
    got = ring.process_all_gather(words).view(torch.uint8)  # (dp, bytes)
    out, at = [], 0
    for x, (nbytes, pad) in zip(xs, spans):
        part = got[:, at:at + nbytes].contiguous().view(x.dtype)
        acc = part[0].clone()
        for p in part[1:]:
            acc += p
        out.append(acc.view(x.shape))
        at += nbytes + pad
    return out


class _ProcessMean(torch.autograd.Function):
    """The mean over the processes of each input, forward and backward:
    the backward of a mean over processes is the mean of the incoming
    gradients over the processes, one exchange each way."""

    @staticmethod
    def forward(ctx, *xs):
        dp = bootstrap.process_count()
        return tuple(t / dp for t in psum_many(xs))

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, n in enumerate(ctx.needs_input_grad) if n]
        out = [None] * len(grads)
        if need:
            dp = bootstrap.process_count()
            summed = psum_many([grads[i] for i in need])
            for i, g in zip(need, summed):
                out[i] = g / dp
        return tuple(out)


def process_pmean(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The mean of each of ``xs`` over the processes (JAX's ``pmean``
    over a data axis that spans the processes), differentiable: one
    exchange forward and one backward, each summing in process order.
    With one process the inputs come back as they are."""
    if bootstrap.process_count() == 1:
        return tuple(xs)
    return _ProcessMean.apply(*xs)


def psum(x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum of every process's ``x``, in process order: process 0's
    part + process 1's + ...; the same bits on every process."""
    return psum_many([x], axis)[0]


def pmean(x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """The mean of every process's ``x``: :func:`psum` (in process order)
    over the process count."""
    return psum(x, axis) / axis_size(axis)


def reduce_scatter(x: torch.Tensor, axis: str = DATA_AXIS, *,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """JAX's tiled ``psum_scatter``: ``x`` is cut along
    ``scatter_dimension`` into ``dp`` blocks, and process j gets the sum
    over the processes of their block j, summed in process order.  Each
    process sends block j to process j (:func:`all_to_all`: B5 across
    processes for a CUDA tensor, gloo for a CPU one), so it moves ``1/dp``
    of the bytes that :func:`psum`'s all-gather moves."""
    _check_axis(axis)
    dp = bootstrap.process_count()
    d = scatter_dimension % x.dim()
    if x.shape[d] % dp:
        raise ValueError(f"reduce_scatter: dim {d} of size {x.shape[d]} "
                         f"does not split over {dp} processes")
    if dp == 1:
        return x.clone()
    y = x.movedim(d, 0)
    got = ring.process_all_to_all(
        y.reshape(dp, y.shape[0] // dp, *y.shape[1:]).contiguous())
    acc = got[0].clone()
    for part in got[1:]:
        acc += part
    return acc.movedim(0, d)


def host_psum(values: Sequence[float]) -> List[float]:
    """Host numbers summed over the processes in process order (float64,
    over gloo): the epoch's loss sums."""
    t = torch.tensor(list(values), dtype=torch.float64)
    if bootstrap.process_count() == 1:
        return t.tolist()
    parts = ring.process_all_gather_plain(t)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc.tolist()


def host_agree(what: str, value) -> None:
    """Raise unless every process holds the same ``value`` (compared by
    the CRC-32 of its ``repr``, over gloo): the host-side decisions that
    every replica must take alike, such as the hybrid head or a window's
    plan."""
    if bootstrap.process_count() == 1:
        return
    mine = zlib.crc32(repr(value).encode())
    got = ring.process_all_gather_plain(
        torch.tensor([mine], dtype=torch.int64))[:, 0].tolist()
    if len(set(got)) != 1:
        raise RuntimeError(
            f"{what} differs across the processes (CRC-32 by process: "
            f"{got}); every replica must take the same decision")


# -- over a rank axis: tensors stacked over the axis's ranks -----------------

def ring_permute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Every rank's block to its ``+shift`` neighbour along the ring:
    ``new[(j + shift) % n] = old[j]``."""
    return torch.roll(x, shifts=shift, dims=0)


def rank_all_to_all(x: torch.Tensor, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over the ranks of ``x``'s leading dim: rank ``r``'s local ``x[r]`` is
    cut along ``split_axis`` (a local dim) into n chunks, chunk ``j`` goes
    to rank ``j``, and each rank concatenates what it received along
    ``concat_axis`` in source order.  Each rank's operand is rearranged to
    ``(n_dest, chunk...)`` and made contiguous, B5 exchanges the stack
    (``result[r, j] = y[j, r]``), and the received chunks are put back
    along ``concat_axis``."""
    n, local = x.shape[0], tuple(x.shape[1:])
    s = split_axis % len(local)
    c = concat_axis % len(local)
    if local[s] % n:
        raise ValueError(f"all_to_all: dim {s} of size {local[s]} does not "
                         f"split over {n} ranks")
    chunk = local[:s] + (local[s] // n,) + local[s + 1:]
    y = x.reshape(n, *local[:s], n, local[s] // n, *local[s + 1:])
    y = y.movedim(1 + s, 1).contiguous()
    got = ring.RingExchange.apply(y)           # (n, n_src, *chunk)
    got = got.movedim(1, 1 + c)
    return got.reshape(n, *chunk[:c], n * chunk[c], *chunk[c + 1:])


def rank_reduce_scatter(x: torch.Tensor, *,
                        scatter_dimension: int = 0) -> torch.Tensor:
    """JAX's tiled ``reduce_scatter`` over the ranks of ``x``'s leading
    dim: rank ``r``'s local ``x[r]`` is cut along ``scatter_dimension`` (a
    local dim) into n blocks, and rank ``j`` gets the sum over the ranks
    of their block ``j``, in rank order.  The blocks go through B5's
    stacked exchange (``kernels.ring.RingExchange``, forward and
    backward), then each rank sums what it received."""
    n, local = x.shape[0], tuple(x.shape[1:])
    s = scatter_dimension % len(local)
    if local[s] % n:
        raise ValueError(f"reduce_scatter: dim {s} of size {local[s]} does "
                         f"not split over {n} ranks")
    y = x.reshape(n, *local[:s], n, local[s] // n, *local[s + 1:])
    got = ring.RingExchange.apply(y.movedim(1 + s, 1).contiguous())
    acc = got[:, 0]
    for j in range(1, n):
        acc = acc + got[:, j]
    return acc


def rank_psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``x``'s leading dim: the value ``psum``
    leaves on every rank, once."""
    return x.sum(0)


def rank_pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of ``x``'s leading dim (``pmean``)."""
    return x.mean(0)
