"""The port's wire ledger against the JAX package's: the same pulls and
pushes on the same seeded inputs leave ``traffic()`` equal key for key on
``xla``, ``tpu`` (8 ranks against ``TpuTransfer`` on the ``devices8``
mesh) and ``local``; the totals never decrease, ``traffic_delta``
subtracts, and nothing is booked with ``count_traffic`` off.  Counts are
integers: held exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftmpi_tpu.cluster import SHARD_AXIS
from swiftmpi_tpu.cluster import ps_mesh as jax_ps_mesh
from swiftmpi_tpu.parameter import KeyIndex as JaxKeyIndex
from swiftmpi_tpu.parameter import SparseTable as JaxSparseTable
from swiftmpi_tpu.parameter import w2v_access as jax_w2v_access
from swiftmpi_tpu.transfer.local import LocalTransfer as JaxLocal
from swiftmpi_tpu.transfer.tpu import TpuTransfer
from swiftmpi_tpu.transfer.xla import XlaTransfer
from swiftmpi_tpu_torch.cluster import ps_mesh
from swiftmpi_tpu_torch.convert import state_from_jax
from swiftmpi_tpu_torch.parameter import w2v_access
from swiftmpi_tpu_torch.transfer.api import WIRE_KEYS, get_transfer

N, CAP, D, LR = 8, 32, 8, 0.3


def _inputs(n, rng, cap):
    slots = rng.integers(0, cap, size=n).astype(np.int32)
    slots[::7] = -1
    slots[1] = slots[0]
    grads = {f: rng.normal(size=(n, D)).astype(np.float32)
             for f in ("h", "v")}
    counts = rng.integers(1, 4, size=n).astype(np.float32)
    counts[slots < 0] = 0
    return slots, grads, counts


def _backends(name, devices8):
    """(jax transfer, jax state, port transfer, port state, the port's
    array maker, capacity)."""
    jacc = jax_w2v_access(learning_rate=LR, len_vec=D)
    if name == "tpu":
        mesh = jax_ps_mesh()
        jtable = JaxSparseTable(jacc, JaxKeyIndex(N, CAP), mesh=mesh,
                                axis=SHARD_AXIS)
        layout = ps_mesh(N, ["cpu"])
        pstate = state_from_jax({f: np.asarray(a)
                                 for f, a in jtable.state.items()}, "cpu",
                                mesh=layout)
        return (TpuTransfer(mesh), jtable.state,
                get_transfer("tpu", mesh=layout), pstate, torch.from_numpy,
                N * CAP)
    jtable = JaxSparseTable(jacc, JaxKeyIndex(1, 4 * CAP))
    np_state = {f: np.asarray(a) for f, a in jtable.state.items()}
    if name == "xla":
        return (XlaTransfer(), jtable.state, get_transfer("xla"),
                state_from_jax(np_state, "cpu"), torch.from_numpy, 4 * CAP)
    return (JaxLocal(), np_state, get_transfer("local"), np_state,
            lambda a: a, 4 * CAP)


def _run(transfer, state, access, calls, conv, jax_side):
    """Replay ``calls`` on one backend, carrying the state each push
    returns (a new one from the functional backends, the same one from
    the port's in-place ones)."""
    for op, slots, grads, counts, kw in calls:
        s = slots if jax_side else conv(slots)
        if op == "pull":
            transfer.pull(state, s, access, **kw)
            continue
        g = grads if jax_side else {f: conv(a) for f, a in grads.items()}
        if op == "push":
            out = transfer.push(state, s, g, access, **kw)
        else:
            c = jnp.asarray(counts) if jax_side else conv(counts)
            out = transfer.push_span(state, s, g, c, access, **kw)
        state = out
    return state


@pytest.mark.parametrize("name", ["xla", "tpu", "local"])
def test_traffic_matches_jax(name, devices8):
    jt, jstate, pt, pstate, conv, cap = _backends(name, devices8)
    jacc = jax_w2v_access(learning_rate=LR, len_vec=D)
    pacc = w2v_access(LR, D)
    rng = np.random.default_rng(3)
    small = _inputs(64, rng, cap)
    calls = [("pull", small[0], None, None, {}),
             ("pull", small[0], None, None, {"fields": ("h",)}),
             ("push", small[0], small[1], None, {"mean": True}),
             ("push", small[0], {"v": small[1]["v"]}, None, {}),
             ("span", *small, {"mean": True})]
    if name == "xla":          # a batch past half the capacity: dense
        calls.append(("push", *_inputs(96, rng, cap)[:2], None,
                      {"mean": True}))
    for t in (jt, pt):
        t.count_traffic = True
    _run(jt, jstate, jacc, calls, None, True)
    _run(pt, pstate, pacc, calls, conv, False)
    want, got = jt.traffic(), pt.traffic()
    assert got == want
    assert got["dispatches"] == len(calls) - 2 and got["pull_rows"] > 0
    if name == "tpu":
        assert got["routed_rows"] > 0 and got["overflow_dropped"] == 0


@pytest.mark.parametrize("name", ["xla", "tpu", "local"])
def test_traffic_totals_never_decrease_and_delta_subtracts(name, devices8):
    _, _, pt, pstate, conv, cap = _backends(name, devices8)
    pacc = w2v_access(LR, D)
    rng = np.random.default_rng(4)
    slots, grads, counts = _inputs(64, rng, cap)
    # off by default: nothing is booked
    _run(pt, pstate, pacc, [("pull", slots, None, None, {})], conv, False)
    assert set(pt.traffic()) >= set(WIRE_KEYS)
    assert not any(pt.traffic().values())
    pt.count_traffic = True
    calls = [("pull", slots, None, None, {}),
             ("push", slots, grads, None, {"mean": True})]
    pstate = _run(pt, pstate, pacc, calls, conv, False)
    first = pt.traffic()
    assert pt.traffic() == first               # reading changes nothing
    pstate = _run(pt, pstate, pacc, calls + [("span", slots, grads, counts,
                                              {})], conv, False)
    second = pt.traffic()
    assert all(second[k] >= first[k] for k in first)
    delta = pt.traffic_delta(first)
    assert delta == {k: second[k] - first[k] for k in second}
    assert delta["dispatches"] == 2 and delta["pull_rows"] == \
        first["pull_rows"]
    assert pt.traffic_delta() == second
