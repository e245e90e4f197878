"""Elastic membership of the port against the JAX package, on the CPU:
the member table (every published ``membership.json`` byte for byte, every
raised error's type), ``plan_placement``, the key index's ownership
helpers, the controller's membership decision, the supervisor's restart
budget, and the elastic worker (``device="cpu"``) in JAX's in-process
sims, each driven on both packages over two fleet directories with the
same table sequence: rows bit for bit, every dump's and migration's npz
arrays equal, census JSON and ``migration_bytes`` equal, losses within
1e-6 relative.
"""

import json
import os

import numpy as np
import pytest
import torch

from swiftmpi_tpu import launch as jax_launch
from swiftmpi_tpu.cluster import membership as jm
from swiftmpi_tpu.cluster.elastic import ElasticWorker as JaxWorker
from swiftmpi_tpu.cluster.elastic import elastic_barrier as jax_barrier
from swiftmpi_tpu.control.controller import Controller as JaxController
from swiftmpi_tpu.control.controller import \
    plan_placement as jax_plan_placement
from swiftmpi_tpu.parameter.key_index import KeyIndex as JaxKeyIndex
from swiftmpi_tpu_torch import launch as port_launch
from swiftmpi_tpu_torch.cluster import membership as pm
from swiftmpi_tpu_torch.cluster.elastic import ElasticWorker, elastic_barrier
from swiftmpi_tpu_torch.cluster.membership import (StaleEpochError,
                                                   acks_complete,
                                                   commit_table,
                                                   initial_table,
                                                   judge_join, plan_death,
                                                   plan_rejoin,
                                                   read_membership,
                                                   rollback_table,
                                                   write_membership)
from swiftmpi_tpu_torch.control.controller import Controller, plan_placement
from swiftmpi_tpu_torch.parameter.key_index import KeyIndex


# ---------------------------------------------------------------------------
# the member table on the port alone (JAX's pure tests, mirrored)

def test_initial_table_round_robin_write_read(tmp_path):
    t = initial_table(4, 8)
    assert t.epoch == 0 and t.state == pm.COMMITTED
    assert t.live == (0, 1, 2, 3)
    assert t.owner_of_shard == (0, 1, 2, 3, 0, 1, 2, 3)
    write_membership(str(tmp_path), t)
    assert read_membership(str(tmp_path)) == t


def test_write_membership_refuses_stale_epoch(tmp_path):
    write_membership(str(tmp_path), initial_table(2, 4))
    with pytest.raises(StaleEpochError):
        write_membership(str(tmp_path), initial_table(2, 4))


def test_write_membership_allows_prepare_to_commit(tmp_path):
    t = write_membership(str(tmp_path), initial_table(3, 6))
    dead = plan_death(t, 2, {s: s % 2 for s in t.shards_of(2)})
    write_membership(str(tmp_path), dead)
    prep = plan_rejoin(dead, 2, {s: 2 for s in (2, 5)})
    write_membership(str(tmp_path), prep)
    committed = write_membership(str(tmp_path), commit_table(prep))
    assert committed.epoch == prep.epoch
    with pytest.raises(StaleEpochError):
        write_membership(str(tmp_path), prep)


def test_plan_death_reassigns_every_orphan():
    t = initial_table(4, 8)
    orphans = t.shards_of(3)
    d = plan_death(t, 3, {s: s % 3 for s in orphans})
    assert 3 not in d.live and d.epoch == 1
    assert set(d.owner_of_shard) <= set(d.live)
    assert sorted(s for s, _, _ in d.moves) == sorted(orphans)
    assert all(src == 3 for _, src, _ in d.moves)
    d.validate()


def test_plan_death_guards():
    t = initial_table(2, 4)
    with pytest.raises(ValueError):
        plan_death(t, 5, {})
    with pytest.raises(ValueError):
        plan_death(t, 1, {})
    lone = plan_death(t, 1, {s: 0 for s in t.shards_of(1)})
    with pytest.raises(ValueError):
        plan_death(lone, 0, {})
    prep = plan_rejoin(lone, 1, {0: 1})
    with pytest.raises(ValueError):
        plan_death(prep, 0, {})


def test_rejoin_prepare_commit_rollback_cycle():
    t = initial_table(3, 6)
    d = plan_death(t, 1, {s: 0 for s in t.shards_of(1)})
    prep = plan_rejoin(d, 1, {1: 1, 4: 1})
    assert prep.state == pm.PREPARE and 1 in prep.live
    assert prep.prev_owner == d.owner_of_shard and prep.prev_live == d.live
    c = commit_table(prep)
    assert c.epoch == prep.epoch and c.state == pm.COMMITTED
    rb = rollback_table(prep, "source died")
    assert rb.epoch == prep.epoch + 1
    assert rb.owner_of_shard == d.owner_of_shard
    assert rb.live == d.live and rb.rolled_back == prep.epoch


def test_judge_join_flags_future_epoch_as_stale():
    t = initial_table(4, 8)
    d = plan_death(t, 2, {s: 0 for s in t.shards_of(2)})
    assert judge_join(d, 2, 0) == "admit"
    assert judge_join(d, 2, d.epoch) == "admit"
    assert judge_join(d, 2, d.epoch + 3) == "stale"


def test_acks_gate_the_commit(tmp_path):
    t = initial_table(3, 6)
    d = plan_death(t, 2, {s: s % 2 for s in t.shards_of(2)})
    prep = plan_rejoin(d, 2, {2: 2, 5: 2})
    assert not acks_complete(str(tmp_path), prep)
    for r in {src for _, src, _ in prep.moves}:
        pm.write_ack(str(tmp_path), prep.epoch, r)
    assert acks_complete(str(tmp_path), prep)
    assert pm.missing_acks(str(tmp_path), plan_rejoin(d, 2, {2: 2})) == []


# ---------------------------------------------------------------------------
# the member table against the JAX package's

def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
            if not n.startswith(".")}


def test_membership_sequence_byte_for_byte(tmp_path):
    """initial, a death with a given assignment, a rejoin's prepare, its
    acks, its commit, a second prepare rolled back, loads, a stale write
    and a stale join: the same calls on both packages publish the same
    bytes, raise the same types, and each package reads the other's
    files."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dp.mkdir()
    seq = []
    for mod, d in ((jm, dj), (pm, dp)):
        d = str(d)
        t = mod.write_membership(d, mod.initial_table(4, 12))
        t = mod.write_membership(d, mod.plan_death(
            t, 2, {s: (0, 1, 3)[i % 3]
                   for i, s in enumerate(t.shards_of(2))}))
        mod.publish_load(d, 0, {0: 2.5, 4: 1.0})
        mod.publish_load(d, 3, {3: 0.25})
        mod.request_join(d, 2, 1)
        prep = mod.write_membership(d, mod.plan_rejoin(t, 2, {0: 2, 7: 2}))
        for r in sorted({src for _, src, _ in prep.moves}):
            mod.write_ack(d, prep.epoch, r, {"dsts": [2]})
        assert mod.acks_complete(d, prep)
        t = mod.write_membership(d, mod.commit_table(prep))
        mod.clear_join(d, 2)
        prep = mod.write_membership(d, mod.plan_rejoin(
            mod.plan_death(t, 1, {s: 0 for s in t.shards_of(1)}), 1, {1: 1}))
        t = mod.write_membership(d, mod.rollback_table(prep, "r3 died"))
        errors = []
        for bad in (lambda: mod.write_membership(d, prep),
                    lambda: mod.write_membership(d, mod.initial_table(4, 12)),
                    lambda: mod.plan_death(prep, 0, {}),
                    lambda: mod.plan_rejoin(t, 0, {1: 0}),
                    lambda: mod.commit_table(t)):
            with pytest.raises(Exception) as e:
                bad()
            errors.append(type(e.value))
        mod.write_reject(d, 1, "claimed epoch 9 is ahead of the world's 5")
        seq.append((errors, mod.judge_join(t, 1, 9),
                    mod.read_loads(d, 12), mod.pending_joins(d)))
    (ej, vj, lj, pj), (ep, vp, lp, pp) = seq
    assert ej[0] is jm.StaleEpochError and ep[0] is pm.StaleEpochError
    assert ej[1] is jm.StaleEpochError and ep[1] is pm.StaleEpochError
    assert ej[2:] == ep[2:] == [ValueError] * 3
    assert not issubclass(pm.StaleEpochError, jm.StaleEpochError)
    assert vj == vp == "stale" and lj == lp and pj == pp
    assert _files(dj) == _files(dp)
    # either package's supervisor reads the other's fleet directory
    assert jm.read_membership(str(dp)) == jm.read_membership(str(dj))
    assert pm.read_membership(str(dj)) == pm.read_membership(str(dp))


def test_membership_every_publish_byte_for_byte(tmp_path):
    """Each publish of a random walk of deaths, rejoins, commits and
    rollbacks, file for file."""
    rng = np.random.default_rng(5)
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dp.mkdir()
    tj = jm.write_membership(str(dj), jm.initial_table(5, 20))
    tp = pm.write_membership(str(dp), pm.initial_table(5, 20))
    for _ in range(30):
        if tj.state == jm.PREPARE:
            if rng.random() < 0.5:
                tj, tp = jm.commit_table(tj), pm.commit_table(tp)
            else:
                tj, tp = jm.rollback_table(tj, "x"), pm.rollback_table(tp,
                                                                       "x")
        elif len(tj.live) > 2 and rng.random() < 0.5:
            dead = int(rng.choice(tj.live))
            cands = [r for r in tj.live if r != dead]
            assign = {s: int(rng.choice(cands)) for s in tj.shards_of(dead)}
            tj, tp = (jm.plan_death(tj, dead, assign),
                      pm.plan_death(tp, dead, assign))
        else:
            out = [r for r in range(5) if r not in tj.live]
            if not out:
                continue
            r = int(rng.choice(out))
            owned = [s for s in range(20)
                     if len(tj.shards_of(tj.owner_of_shard[s])) > 1]
            assign = {int(s): r for s in rng.choice(owned, 2, replace=False)}
            tj, tp = jm.plan_rejoin(tj, r, assign), pm.plan_rejoin(tp, r,
                                                                   assign)
        jm.write_membership(str(dj), tj)
        pm.write_membership(str(dp), tp)
        assert (dj / "membership.json").read_bytes() \
            == (dp / "membership.json").read_bytes()
        assert tp.to_json() == tj.to_json()


# ---------------------------------------------------------------------------
# placement, the key index's helpers, the controller's decision

def test_plan_placement_balances_by_load():
    loads = {0: [9.0, 1.0, 1.0, 1.0, 0.0, 0.0]}
    assign = plan_placement([0, 1, 2, 3], [1, 2], shard_loads=loads,
                            current_owner=[0, 0, 0, 0, 1, 2])
    assert set(assign) == {0, 1, 2, 3} and set(assign.values()) <= {1, 2}
    assert [assign[s] for s in (1, 2, 3)].count(assign[0]) < 3


def test_plan_placement_degrades_to_count_balance():
    assign = plan_placement([0, 1, 2, 3, 4, 5], [7, 8, 9])
    per = {r: sum(1 for d in assign.values() if d == r) for r in (7, 8, 9)}
    assert all(v == 2 for v in per.values())
    with pytest.raises(ValueError):
        plan_placement([0], [])


@pytest.mark.parametrize("seed", range(8))
def test_plan_placement_equals_jax(seed):
    """Seeded random shards, candidates, loads (zeros and ties among
    them) and owners: the same assignment, tie-breaks included."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n, world = int(rng.integers(2, 40)), int(rng.integers(2, 9))
        owner = [int(x) for x in rng.integers(0, world, n)]
        dead = int(rng.integers(0, world))
        shards = [s for s in range(n) if owner[s] == dead]
        cands = [r for r in range(world) if r != dead]
        loads = {r: [float(v) for v in rng.choice(
            [0.0, 0.5, 1.0, 2.0, 3.0], n)] for r in cands
            if rng.random() < 0.7}
        for args in ((shards, cands, loads, owner), (shards, cands),
                     (shards, cands, loads, None)):
            assert plan_placement(*args) == jax_plan_placement(*args)


def test_key_index_ownership_helpers_equal_jax():
    rng = np.random.default_rng(3)
    jk, pk = JaxKeyIndex(4, 64), KeyIndex(4, 64)
    for _ in range(3):
        keys = rng.integers(1, 1 << 40, 60).astype(np.uint64)
        np.testing.assert_array_equal(jk.lookup(keys), pk.lookup(keys))
    jk.grow(128)
    pk.grow(128)
    keys = rng.integers(1, 1 << 40, 50).astype(np.uint64)
    np.testing.assert_array_equal(jk.lookup(keys), pk.lookup(keys))
    for s in range(4):
        for a, b in zip(jk.shard_rows(s), pk.shard_rows(s)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no owner map"):
        pk.owner_moves([0, 1, 2, 3], 0)
    for k in (jk, pk):
        k.adopt_owner_map([0, 1, 2, 3], epoch=2)
    for new, rank in (([0, 1, 2, 1], 3), ([0, 1, 2, 1], 1),
                      ([2, 2, 2, 2], 2), ([0, 1, 2, 3], 0)):
        assert pk.owner_moves(new, rank) == jk.owner_moves(new, rank)
    with pytest.raises(StaleEpochError, match="regressed"):
        pk.adopt_owner_map([0, 1, 2, 3], epoch=1)
    with pytest.raises(jm.StaleEpochError):
        jk.adopt_owner_map([0, 1, 2, 3], epoch=1)
    with pytest.raises(ValueError, match="covers 2 shards"):
        pk.adopt_owner_map([0, 1], epoch=3)
    pk.adopt_owner_map([1, 1, 2, 3], epoch=2)
    assert pk.shard_owner == (1, 1, 2, 3) and pk.owner_epoch == 2


def test_on_membership_change_decision_equals_jax():
    assign = {5: 1, 2: 0, 9: 3}
    from swiftmpi_tpu.control.controller import \
        ControlSettings as JaxSettings
    from swiftmpi_tpu_torch.control.controller import ControlSettings
    dj = JaxController(JaxSettings()).on_membership_change(
        4, [0, 1, 3], assign, evidence={"reason": "death:r2"})
    dp = Controller(ControlSettings()).on_membership_change(
        4, [0, 1, 3], assign, evidence={"reason": "death:r2"})
    assert dp.to_payload() == dj.to_payload()
    assert json.dumps(dp.to_payload()) == json.dumps(dj.to_payload())


# ---------------------------------------------------------------------------
# the supervisor's restart budget (JAX's fake-time drive, both packages)

class _FakeTime:
    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _run_supervise(mod, script, monkeypatch, **kw):
    ft = _FakeTime()
    calls = []

    def fake_launch(argv, nprocs, *a, **k):
        ran_s, rc = script[len(calls)]
        calls.append(rc)
        ft.t += ran_s
        return rc

    monkeypatch.setattr(mod, "time", ft)
    monkeypatch.setattr(mod, "launch", fake_launch)
    rc = mod.supervise([], 1, max_restarts=2, backoff_s=0.1, **kw)
    return rc, len(calls)


@pytest.mark.parametrize("script,kw,want", [
    # four stable-period crashes then success: the budget resets
    ([(10.0, 1)] * 4 + [(10.0, 0)], {"stable_after_s": 5.0}, (0, 5)),
    # without stable_after the budget exhausts: initial + 2 restarts
    ([(10.0, 1)] * 4 + [(10.0, 0)], {}, (1, 3)),
    # crashes faster than the stable period still burn the budget
    ([(1.0, 1)] * 4 + [(10.0, 0)], {"stable_after_s": 5.0}, (1, 3)),
], ids=["stable_after_resets", "budget_exhausts", "quick_crash_loop"])
def test_supervise_restart_budget(script, kw, want, monkeypatch):
    got = _run_supervise(port_launch, script, monkeypatch, **kw)
    assert got == want
    assert _run_supervise(jax_launch, script, monkeypatch, **kw) == got


# ---------------------------------------------------------------------------
# the elastic worker against the JAX package's, in-process sims

class Twin:
    """The same fleet on both packages: JAX workers over one fleet
    directory, the port's (``device="cpu"``) over another, each table
    transition made by each package's own functions and published to its
    directory, byte for byte the same."""

    def __init__(self, tmp_path, world, n_shards=8, steps=3, quant="off",
                 dim=4):
        self.dj, self.dp = tmp_path / "jax", tmp_path / "port"
        self.dj.mkdir()
        self.dp.mkdir()
        self.n_shards, self.quant, self.dim = n_shards, quant, dim
        self.tj = jm.write_membership(str(self.dj),
                                      jm.initial_table(world, n_shards))
        self.tp = pm.write_membership(str(self.dp),
                                      pm.initial_table(world, n_shards))
        self.j, self.p = {}, {}
        for r in range(world):
            self.add(r)
            assert self.boot(r)
        for _ in range(steps):
            for r in list(self.j):
                self.sync(r)
                self.step(r)

    def make(self, r, **kw):
        args = dict(world_size=len(self.tj.live) if kw.get("world") is None
                    else kw["world"], n_shards=self.n_shards,
                    rows_per_shard=4, dim=self.dim, dump_every=1,
                    quant=self.quant)
        return (JaxWorker(r, str(self.dj), **args),
                ElasticWorker(r, str(self.dp), **args, device="cpu"))

    def add(self, r, world=None):
        self.j[r], self.p[r] = self.make(r, world=world)

    def boot(self, r):
        a = self.j[r].boot(timeout_s=2.0)
        b = self.p[r].boot(timeout_s=2.0)
        assert a == b
        return a

    def pop(self, r):
        return self.j.pop(r), self.p.pop(r)

    def publish(self, fn):
        """``fn(module, table)`` on both packages, published to both
        directories; the two files must be byte-equal."""
        self.tj = jm.write_membership(str(self.dj), fn(jm, self.tj))
        self.tp = pm.write_membership(str(self.dp), fn(pm, self.tp))
        assert (self.dj / "membership.json").read_bytes() \
            == (self.dp / "membership.json").read_bytes()
        return self.tp

    def sync(self, r):
        ej, ep = self.j[r].sync(), self.p[r].sync()
        assert ep == ej
        return ep

    def step(self, r):
        a, b = self.j[r].step(), self.p[r].step()
        assert b == pytest.approx(a, rel=1e-6, abs=1e-12)
        return b

    def loss(self, r):
        a, b = self.j[r].loss(), self.p[r].loss()
        assert b == pytest.approx(a, rel=1e-6, abs=1e-12)
        return b

    def check(self):
        """Rows bit for bit, every npz's arrays equal key for key, every
        census JSON and ack equal, ``migration_bytes`` and moves equal."""
        for r in self.j:
            wj, wp = self.j[r], self.p[r]
            rj, rp = wj.rows, wp.rows_dict()
            assert sorted(rp) == sorted(rj) == wp.owned_keys()
            for k in rj:
                assert np.array_equal(rp[k], rj[k]), (r, k)
            assert wp.migration_bytes == wj.migration_bytes
            assert wp.moves_applied == wj.moves_applied
            assert wp.epoch == wj.epoch
            assert wp.rows.device.type == "cpu"
        names = sorted(n for n in os.listdir(self.dj)
                       if not n.startswith("."))
        assert names == sorted(n for n in os.listdir(self.dp)
                               if not n.startswith("."))
        for n in names:
            if n.endswith(".npz"):
                with np.load(self.dj / n) as zj, np.load(self.dp / n) as zp:
                    assert sorted(zj.files) == sorted(zp.files), n
                    for f in zj.files:
                        assert zj[f].dtype == zp[f].dtype, (n, f)
                        np.testing.assert_array_equal(zp[f], zj[f])
            elif not n.startswith("barrier"):
                assert (self.dp / n).read_bytes() \
                    == (self.dj / n).read_bytes(), n


def _census(tw, live):
    owned = {}
    for r in live:
        for k in tw.p[r].owned_keys():
            owned.setdefault(k, []).append(r)
    return owned


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_death_adoption_from_last_dump(tmp_path, quant):
    tw = Twin(tmp_path, 3, n_shards=6, quant=quant)
    dead_j, dead_p = tw.pop(2)
    assign = plan_placement(tw.tp.shards_of(2), [0, 1],
                            current_owner=tw.tp.owner_of_shard)
    tw.publish(lambda m, t: m.plan_death(t, 2, assign))
    for r in (0, 1):
        assert any(e["kind"] == "adopt" for e in tw.sync(r))
    tw.check()
    owned = _census(tw, (0, 1))
    assert sorted(owned) == list(range(6 * 4))
    assert all(len(v) == 1 for v in owned.values())
    if quant == "off":
        dead_rows = dead_p.rows_dict()
        for k in dead_p.owned_keys():
            np.testing.assert_array_equal(
                tw.p[owned[k][0]].rows_dict()[k], dead_rows[k])
    pre = [tw.loss(r) for r in (0, 1)]
    for _ in range(6):
        for r in (0, 1):
            tw.step(r)
    post = [tw.loss(r) for r in (0, 1)]
    assert all(p < q or q == 0.0 for p, q in zip(post, pre))
    tw.check()


def test_rejoin_two_phase_moves_rows_exactly_once(tmp_path):
    tw = Twin(tmp_path, 3, n_shards=6)
    tw.pop(2)
    assign = plan_placement(tw.tp.shards_of(2), [0, 1],
                            current_owner=tw.tp.owner_of_shard)
    t = tw.publish(lambda m, t: m.plan_death(t, 2, assign))
    for r in (0, 1):
        tw.sync(r)
    handback = {t.shards_of(0)[0]: 2, t.shards_of(1)[0]: 2}
    prep = tw.publish(lambda m, t: m.plan_rejoin(t, 2, handback))
    src_rows = {s: {k: tw.p[r].rows_dict()[k]
                    for k in tw.p[r].keys_of_shard(s)}
                for s, r, _ in prep.moves}
    for r in (0, 1):
        assert any(e["kind"] == "prepare" for e in tw.sync(r))
    tw.check()
    assert acks_complete(str(tw.dp), prep)
    tw.publish(lambda m, t: m.commit_table(t))
    for r in (0, 1):
        assert any(e["kind"] == "commit" for e in tw.sync(r))
    tw.add(2, world=3)
    assert tw.boot(2)
    tw.check()
    owned = _census(tw, (0, 1, 2))
    assert all(len(v) == 1 for v in owned.values())
    got = tw.p[2].rows_dict()
    for rows in src_rows.values():
        for k, v in rows.items():
            assert owned[k] == [2]
            np.testing.assert_array_equal(got[k], v)
    for _ in range(2):
        for r in (0, 1, 2):
            tw.sync(r)
            tw.step(r)
    tw.check()


def test_rollback_mid_prepare_strands_nothing(tmp_path):
    tw = Twin(tmp_path, 3, n_shards=6)
    tw.pop(2)
    assign = plan_placement(tw.tp.shards_of(2), [0, 1],
                            current_owner=tw.tp.owner_of_shard)
    t = tw.publish(lambda m, t: m.plan_death(t, 2, assign))
    for r in (0, 1):
        tw.sync(r)
    pre = tw.p[0].rows_dict()
    tw.publish(lambda m, t: m.plan_rejoin(
        t, 2, {t.shards_of(0)[0]: 2, t.shards_of(1)[0]: 2}))
    tw.sync(0)                           # rank 0 exports + acks
    rb = tw.publish(lambda m, t: m.rollback_table(t, "rollback:r1 died"))
    assert any(e["kind"] == "rollback" for e in tw.sync(0))
    assert tw.p[0].owned_keys() == sorted(pre)
    for k, v in tw.p[0].rows_dict().items():
        np.testing.assert_array_equal(v, pre[k])
    tw.pop(1)
    tw.publish(lambda m, t: m.plan_death(
        t, 1, {s: 0 for s in rb.shards_of(1)}))
    tw.sync(0)
    tw.check()
    owned = _census(tw, (0,))
    assert all(len(v) == 1 for v in owned.values())
    assert sorted(owned) == list(range(6 * 4))


def test_double_kill_census_exactly_once(tmp_path):
    tw = Twin(tmp_path, 4, n_shards=8)
    for dead in (3, 1):
        tw.pop(dead)
        live = [r for r in tw.tp.live if r != dead]
        assign = plan_placement(tw.tp.shards_of(dead), live,
                                current_owner=tw.tp.owner_of_shard)
        tw.publish(lambda m, t: m.plan_death(t, dead, assign))
        for r in list(tw.p):
            tw.sync(r)
            tw.step(r)
    tw.check()
    owned = _census(tw, tuple(tw.p))
    assert sorted(owned) == list(range(8 * 4))
    assert all(len(v) == 1 for v in owned.values())


def test_sync_raises_loudly_on_epoch_regression(tmp_path):
    tw = Twin(tmp_path, 2, n_shards=4)
    old_j, old_p = tw.tj, tw.tp
    tw.publish(lambda m, t: m.plan_death(t, 1, {s: 0
                                                for s in t.shards_of(1)}))
    tw.sync(0)
    jm._atomic_write(jm.membership_path(str(tw.dj)), old_j.to_json())
    pm._atomic_write(pm.membership_path(str(tw.dp)), old_p.to_json())
    with pytest.raises(jm.StaleEpochError):
        tw.j[0].sync()
    with pytest.raises(StaleEpochError, match="regressed"):
        tw.p[0].sync()


def test_stale_join_rejected_loudly(tmp_path):
    tw = Twin(tmp_path, 2, n_shards=4)
    t = tw.publish(lambda m, t: m.plan_death(t, 1, {s: 0
                                                    for s in t.shards_of(1)}))
    assert judge_join(t, 1, claimed_epoch=t.epoch + 5) == "stale"
    reason = f"claimed epoch {t.epoch + 5} ahead of world epoch {t.epoch}"
    jm.write_reject(str(tw.dj), 1, reason)
    pm.write_reject(str(tw.dp), 1, reason)
    tw.pop(1)
    tw.add(1, world=2)
    with pytest.raises(jm.StaleEpochError):
        tw.j[1].boot(timeout_s=2.0)
    with pytest.raises(StaleEpochError, match="join rejected"):
        tw.p[1].boot(timeout_s=2.0)


def test_elastic_barrier_reports_stragglers(tmp_path):
    for barrier, d in ((elastic_barrier, tmp_path / "p"),
                       (jax_barrier, tmp_path / "j")):
        d.mkdir()
        assert barrier(str(d), 3, 0, live=[0]) == []
        barrier(str(d), 4, 1, live=[1], timeout_s=0.2)
        assert barrier(str(d), 4, 0, live=[0, 1, 2], timeout_s=0.3) == [2]
    assert sorted(os.listdir(tmp_path / "p")) \
        == sorted(os.listdir(tmp_path / "j"))


def test_elastic_worker_rows_live_on_its_device(tmp_path, monkeypatch):
    """One (capacity, dim) float32 tensor on the device beside an
    owned-key mask; the targets are JAX's float64 expression, bit for
    bit; with no CUDA device and no CPU request the worker raises."""
    w = ElasticWorker(0, str(tmp_path), world_size=1, n_shards=6,
                      rows_per_shard=5, dim=7, device="cpu")
    assert w.rows.shape == (30, 7) and w.rows.dtype == torch.float32
    assert w.owned.shape == (30,) and not w.owned.any()
    ref = JaxWorker(0, str(tmp_path), world_size=1, n_shards=6,
                    rows_per_shard=5, dim=7)
    for k in range(30):
        np.testing.assert_array_equal(w._targets[k].numpy(), ref.target(k))
        np.testing.assert_array_equal(w.target(k), ref.target(k))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticWorker(0, str(tmp_path), world_size=1, n_shards=2)


def test_dumps_and_exports_read_through_the_gather_kernel(tmp_path,
                                                          monkeypatch):
    """A dump is one masked-gather call over the owned keys; a prepare's
    export one call over every destination's keys."""
    from swiftmpi_tpu_torch.cluster import elastic as elastic_mod
    calls = []
    real = elastic_mod.gather.masked_gather

    def spy(table, slots, valid, out=None):
        calls.append(slots.numel())
        return real(table, slots, valid, out)

    monkeypatch.setattr(elastic_mod.gather, "masked_gather", spy)
    tw = Twin(tmp_path, 3, n_shards=6, steps=1)
    assert calls == [8, 8, 8]            # one dump a rank, 2 shards x 4
    tw.pop(2)
    t = tw.publish(lambda m, t: m.plan_death(
        t, 2, {s: 0 for s in t.shards_of(2)}))
    tw.sync(0)
    tw.sync(1)
    calls.clear()
    tw.publish(lambda m, t: m.plan_rejoin(
        t, 2, {t.shards_of(0)[0]: 2, t.shards_of(0)[1]: 2}))
    tw.sync(0)
    assert calls == [8]                  # both shards, one launch
    tw.check()
