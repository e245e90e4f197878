"""The port's supervised launcher on the CPU: restart-the-world against
the JAX package's supervisor over the same torch-free child (the same rc
and the same supervisor events); the word2vec job restarted from its
checkpoint across processes in both packages, each held byte for byte on
the job stopped and relaunched at the kill's iteration, and why a resumed
iteration draws a fresh process's first streams in both; one elastic
world and one serve fleet with the port's children on ``-device cpu`` (a
rank, a replica killed mid-run), held on their evidence (epochs, census,
attribution, versions) and read with both packages' ``FleetCollector``;
a rank that hangs before its first heartbeat killed as hung.  The serve
trainer's device update is held against the JAX child's numpy update:
every shipped payload equal.

Every launch has a ``timeout=``; the launch drills run once per file, side
by side.
"""
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from swiftmpi_tpu import launch as jax_launch
from swiftmpi_tpu.obs.collector import FleetCollector as JaxCollector
from swiftmpi_tpu_torch import launch as port_launch
from swiftmpi_tpu_torch.data.text import write_tokens_file
from swiftmpi_tpu_torch.obs.collector import FleetCollector
from swiftmpi_tpu_torch.obs.registry import parse_series_key
from swiftmpi_tpu_torch.serve.shipper import read_manifest
from swiftmpi_tpu_torch.testing.faults import FaultPlan

REPO = Path(__file__).resolve().parents[1]


def _launch(args, env_extra, timeout=120):
    env = dict(os.environ, SMTPU_DIST_TIMEOUT="60", **env_extra)
    return subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _events(fleet_dir):
    with open(os.path.join(fleet_dir, "supervisor.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# restart-the-world against the JAX package's supervisor

#: fails once: rank 1 exits 3 once rank 0 is up; rank 0 of that attempt
#: waits to be torn down; the next attempt exits 0 on both ranks, rank 0
#: first.  ``SMTPU_TEST_ALWAYS`` fails every attempt.
_ONCE = """
import os, sys, time
r, m = os.environ["SMTPU_PROCESS_ID"], os.environ["SMTPU_TEST_MARKER"]
if os.environ.get("SMTPU_TEST_ALWAYS") or not os.path.exists(m):
    if r == "0":
        open(m + ".r0", "w").close()
        time.sleep(60)
    while not os.path.exists(m + ".r0"):
        time.sleep(0.01)
    open(m, "w").close()
    sys.exit(3)
if r == "1":
    time.sleep(0.5)
"""


def _normalised(fleet_dir):
    return [{k: v for k, v in e.items() if k not in ("pid", "ts", "argv")}
            for e in _events(fleet_dir)]


@pytest.mark.parametrize("always", [False, True],
                         ids=["recovers", "budget_exhausted"])
def test_supervise_matches_jax_events(tmp_path, monkeypatch, always):
    argv = [sys.executable, "-c", _ONCE]
    got = {}
    if always:
        monkeypatch.setenv("SMTPU_TEST_ALWAYS", "1")
    for name, mod in (("jax", jax_launch), ("port", port_launch)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("SMTPU_TEST_MARKER", str(d / "marker"))
        rc = mod.supervise(argv, 2, max_restarts=1, backoff_s=0.05,
                           fleet_dir=str(d / "fleet"))
        got[name] = (rc, _normalised(d / "fleet"))
    assert got["port"] == got["jax"]
    rc, events = got["port"]
    assert rc == (3 if always else 0)
    kinds = [e["kind"] for e in events]
    assert kinds.count("spawn") == 4 and kinds.count("exit") == 4
    first = [e for e in events if e["kind"] == "exit" and e["attempt"] == 0]
    assert [(e["rank"], e["rc"], e["by_supervisor"]) for e in first] \
        == [(1, 3, False), (0, 143, True)]
    assert kinds[-1] == "world_exit" and events[-1]["rc"] == rc


#: rank 1 fails every life; the others exit 0 a moment later
_FLAKY = """
import os, sys, time
if os.environ["SMTPU_PROCESS_ID"] == "1":
    time.sleep(0.2)
    sys.exit(5)
time.sleep(1.5)
"""


def _ordered(events):
    """Events without pid, ts, argv and the ship directory's path; the
    clean exits of one poll round (their order within it is the poll's)
    by rank."""
    out = [{k: v for k, v in e.items()
            if k not in ("pid", "ts", "argv", "ship_dir")} for e in events]
    clean = sorted((e for e in out if e["kind"] == "exit" and e["rc"] == 0),
                   key=lambda e: e["rank"])
    it = iter(clean)
    return [next(it) if e["kind"] == "exit" and e["rc"] == 0 else e
            for e in out]


@pytest.mark.parametrize("mode", ["elastic", "serve"])
def test_per_rank_supervisors_abandon_as_jax(tmp_path, mode):
    """A rank that fails every life is restarted once, then abandoned;
    the world carries on, reaps every other rank and returns the
    abandoned rank's rc: the port's elastic and serve supervisors publish
    the JAX package's events (epochs included)."""
    argv = [sys.executable, "-c", _FLAKY]
    got = {}
    for name, mod in (("jax", jax_launch), ("port", port_launch)):
        d = str(tmp_path / name)
        if mode == "elastic":
            rc = mod.supervise_elastic(argv, 2, fleet_dir=d, max_restarts=1,
                                       backoff_s=0.05)
        else:
            rc = mod.supervise_serve(argv, 2, fleet_dir=d, max_restarts=1,
                                     backoff_s=0.05)
        got[name] = (rc, _ordered(_events(d)))
    assert got["port"] == got["jax"]
    rc, events = got["port"]
    assert rc == 5
    assert events[-1]["kind"] == "world_exit" \
        and events[-1]["abandoned"] == [1]
    assert [e["rank"] for e in events if e["kind"] == "exit"
            and e["rc"] == 0] == ([0] if mode == "elastic" else [0, 2])


#: hangs before its first heartbeat in its first life (for a minute, then
#: exits 0 as if nothing happened), exits 0 at once in the next; the
#: marker file is its argument
_HANGS_AT_START = """
import os, sys, time
if not os.path.exists(sys.argv[1]):
    open(sys.argv[1], "w").close()
    time.sleep(60)
"""


def _hang_drill(d):
    """``supervise_elastic`` over one rank that hangs before its first
    heartbeat, ``dead_after_s`` 5 (the collector's least) and the
    start-up grace cut to 0.5 s (this process runs no other
    supervisor)."""
    grace = port_launch.START_GRACE_S
    port_launch.START_GRACE_S = 0.5
    try:
        rc = port_launch.supervise_elastic(
            [sys.executable, "-c", _HANGS_AT_START, str(d / "marker")], 1,
            fleet_dir=str(d / "fleet"), max_restarts=1, backoff_s=0.05,
            dead_after_s=5.0)
    finally:
        port_launch.START_GRACE_S = grace
    return rc, d / "fleet"


def test_elastic_kills_a_rank_that_hangs_before_its_first_heartbeat(
        worlds):
    """``-dead-after`` judges a life that has no stream yet on its
    start-up: silent ``dead_after_s + START_GRACE_S`` past its spawn, it
    is killed as hung and restarted (a start-up hang is never seen by
    the streams' health alone)."""
    rc, d = worlds["hang"]
    events = _events(d)
    assert rc == 0
    assert [e["rank"] for e in events if e["kind"] == "hang_kill"] == [0]
    assert [(e["rc"], e["by_supervisor"], e["attempt"]) for e in events
            if e["kind"] == "exit"] == [(137, True, 0), (0, False, 1)]


_W2V_CONF = ("[cluster]\nserver_num: 1\ntransfer: xla\n[word2vec]\n"
             "len_vec: 8\nwindow: 2\nnegative: 3\nsample: -1\n"
             "[worker]\nminibatch: 256\n")


def _w2v_drill(pkg, d, tmp, niters, supervisor=(), env_extra=None):
    """``<pkg>.launch -np 2 [supervisor] -fleet-dir d/fleet -- <pkg>.apps.
    w2v_main -checkpoint d/ck -output d/v.txt`` over the shared corpus and
    conf: the port's children on ``-device cpu``, JAX's on one virtual
    CPU device each (``-cpu 1``)."""
    jax = pkg == "swiftmpi_tpu"
    env = dict(os.environ, SMTPU_DIST_TIMEOUT="60", **(env_extra or {}))
    args = [sys.executable, "-m", f"{pkg}.launch", "-np", "2",
            *(["-cpu", "1"] if jax else []), *supervisor, "-fleet-dir",
            str(d / "fleet"), "--", sys.executable, "-m",
            f"{pkg}.apps.w2v_main", "-config", str(tmp / "w.conf"), "-data",
            str(tmp / "corpus.txt"), "-niters", str(niters), "-checkpoint",
            str(d / "ck"), "-output", str(d / "v.txt"),
            *([] if jax else ["-device", "cpu"])]
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


#: JAX's w2v_main does not shut its distributed runtime down: on a busy
#: CPU a process that outlives the coordinator's can abort (rc 134) at its
#: exit, after its work.  The JAX drills get restarts to absorb that; a
#: restart after the last iteration trains nothing, one at the start
#: retrains from iteration 0, so the dumps they are held on do not move.
_JAX_RESTARTS = {"killed": "3", "resumed": "2"}


def _restart_drills(tmp):
    """In each package, ``launch -np 2 -max-restarts R -fleet-dir D --
    w2v_main -checkpoint`` with rank 1 killed at the top of iteration 2
    (``killed``), and the same job stopped after iteration 2 and launched
    again on its checkpoint (``resumed``: two launches); for the port
    also the job unkilled.  The drills run side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from swiftmpi_tpu.testing.faults import FaultPlan as JaxFaultPlan
    corpus = np.random.default_rng(5).integers(1, 40, size=(40, 10))
    write_tokens_file(corpus, str(tmp / "corpus.txt"))
    (tmp / "w.conf").write_text(_W2V_CONF)
    plans = {"swiftmpi_tpu": JaxFaultPlan, "swiftmpi_tpu_torch": FaultPlan}

    def restarts(pkg, name):
        n = _JAX_RESTARTS[name] if pkg == "swiftmpi_tpu" else \
            {"killed": "1", "resumed": "0"}[name]
        return ["-max-restarts", n, "-backoff", "0.2"]

    def killed(pkg):
        d = tmp / f"{pkg}_killed"
        d.mkdir()
        plan = plans[pkg]().kill_rank(1, at_step=2,
                                      marker=str(d / "kill_marker"))
        return _w2v_drill(pkg, d, tmp, 4, restarts(pkg, "killed"),
                          {"SMTPU_FAULT_PLAN": plan.to_json()}), d

    def resumed(pkg):
        d = tmp / f"{pkg}_resumed"
        d.mkdir()
        return [_w2v_drill(pkg, d, tmp, n, restarts(pkg, "resumed"))
                for n in (2, 4)], d

    def unkilled(pkg):
        d = tmp / f"{pkg}_unkilled"
        d.mkdir()
        return _w2v_drill(pkg, d, tmp, 4), d

    jobs = {(pkg, name): fn for pkg in plans
            for name, fn in (("killed", killed), ("resumed", resumed))}
    jobs["swiftmpi_tpu_torch", "unkilled"] = unkilled
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn, k[0]) for k, fn in jobs.items()}
        runs = {k: f.result() for k, f in futures.items()}
    return {("jax" if pkg == "swiftmpi_tpu" else "port", name): run
            for (pkg, name), run in runs.items()}


def _final_loss(stdout):
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("[rank 0]") and "final error:" in ln]
    return float(lines[-1].split("final error:")[1].split(";")[0])


def _iterations(stdout):
    """Process 0's ``iter k: error e`` lines as (k, e), in order."""
    out = []
    for ln in stdout.splitlines():
        if ln.startswith("[rank 0]") and "] iter " in ln \
                and ": error " in ln:
            k, e = ln.split("] iter ", 1)[1].split(": error ")
            out.append((int(k), e.split()[0]))
    return out


def _held_restart(restart_world, pkg):
    """The restarted world's evidence, in either package: rc 0, rank 1's
    one death its own SIGKILL, both processes resumed at iteration 2 and
    the second life numbering its iterations from 0 again (its streams
    start where a fresh launch's start), and the final table is the
    job's stopped after iteration 2 and launched again, the dump byte for
    byte (a resume from another generation or on other streams would
    differ)."""
    (res, d) = restart_world[pkg, "killed"]
    (stops, dr) = restart_world[pkg, "resumed"]
    for r in (res, *stops):
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    events = _events(d / "fleet")
    organic = [e for e in events if e["kind"] == "exit" and e["rank"] == 1
               and e["rc"] == 137 and not e["by_supervisor"]]
    assert len(organic) == 1 and (d / "kill_marker").exists()
    lines = res.stdout.splitlines()
    at2 = [i for i, ln in enumerate(lines)
           if "found valid checkpoint" in ln and "at iter 2;" in ln]
    assert sorted(lines[i][:8] for i in at2) == ["[rank 0]", "[rank 1]"]
    after = _iterations("\n".join(lines[max(i for i in at2
                                               if lines[i][:8] ==
                                               "[rank 0]"):]))
    assert [k for k, _ in after][:2] == [0, 1]
    assert (d / "v.txt").read_bytes() == (dr / "v.txt").read_bytes()
    return res, d, events


def test_restart_the_world_resumes_from_the_checkpoint(restart_world):
    """The port's restarted world: the evidence of ``_held_restart``, and
    exactly one restart of 4 spawns, every iteration's loss the stopped
    and relaunched job's, the first life the unkilled job's, one dump
    written by process 0, the final loss within phase 9's 20% of the
    unkilled job's, rank 1's two lives merged by the collector."""
    res, d, events = _held_restart(restart_world, "port")
    kinds = [e["kind"] for e in events]
    assert kinds.count("spawn") == 4 and kinds.count("restart") == 1
    organic = [e for e in events if e["kind"] == "exit" and e["rank"] == 1
               and e["attempt"] == 0]
    assert [(e["rc"], e["by_supervisor"]) for e in organic] == [(137, False)]
    stops = restart_world["port", "resumed"][0]
    lives = _iterations(res.stdout)
    assert lives == _iterations(stops[0].stdout) \
        + _iterations(stops[1].stdout)
    wrote = [ln for ln in res.stdout.splitlines() if "wrote" in ln]
    assert len(wrote) == 1 and wrote[0].startswith("[rank 0]")
    unkilled = restart_world["port", "unkilled"][0]
    assert unkilled.returncode == 0
    # up to the kill the killed world is the unkilled one
    assert lives[:2] == _iterations(unkilled.stdout)[:2]
    want = _final_loss(unkilled.stdout)
    assert abs(_final_loss(res.stdout) - want) <= 0.2 * abs(want)
    fc = FleetCollector(str(d / "fleet"))
    fc.poll(final=True)
    m = fc.members()
    assert m["1"]["restarts"] == 1 and len(set(m["1"]["pids"])) == 2
    assert m["0"]["restarts"] == 1
    assert fc.summary()["unnoticed_deaths"] == []
    assert "restart" not in [e["kind"] for e in _events(
        restart_world["port", "unkilled"][1] / "fleet")]


def test_jax_restart_the_world_is_the_same_resume(restart_world):
    """JAX's launcher over JAX's w2v_main, the same corpus, conf and kill
    plan, holds the same evidence as the port (``_held_restart``): its
    restarted world too is the job stopped after iteration 2 and launched
    again, its second life's iterations numbered from 0.  The loss values
    are not compared across the packages: their initial tables and
    negatives come from different generators (threefry in JAX, torch's in
    the port)."""
    _held_restart(restart_world, "jax")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_resumed_iteration_draws_a_fresh_processs_first_streams(
        tmp_path, pkg):
    """Why a world resumed at iteration k reports a lower loss than the
    unkilled one: in both packages ``train_with_resume`` starts the
    batcher's and the negatives' streams afresh, so the resumed
    iteration k is a fresh model's iteration 0 (the first epoch's
    batches and draws) on the checkpointed table, not the unkilled
    run's iteration k."""
    if pkg == "jax":
        from swiftmpi_tpu.io.resilience import train_with_resume
        from swiftmpi_tpu.models.word2vec import Word2Vec
        from swiftmpi_tpu.utils import ConfigParser
        kw = {}
    else:
        from swiftmpi_tpu_torch.io.resilience import train_with_resume
        from swiftmpi_tpu_torch.models.word2vec import Word2Vec
        from swiftmpi_tpu_torch.utils import ConfigParser
        kw = {"device": "cpu"}
    (tmp_path / "w.conf").write_text(_W2V_CONF)
    corpus = np.random.default_rng(5).integers(1, 40, size=(40, 10))
    sents = corpus.tolist()

    def model():
        m = Word2Vec(config=ConfigParser(str(tmp_path / "w.conf")), **kw)
        m.build(sents)
        return m

    u, ck = str(tmp_path / "u"), str(tmp_path / "ck")
    unkilled = train_with_resume(model(), sents, niters=3,
                                 checkpoint_path=u)
    # the generation before the last: the unkilled run at iteration 2
    at2 = max(glob.glob(u + ".g*.npz"),
              key=lambda p: int(p.rsplit(".g", 1)[1][:-len(".npz")]))
    shutil.copy(at2, ck + ".npz")
    resumed = train_with_resume(model(), sents, niters=3,
                                checkpoint_path=ck)
    fresh = model()
    assert fresh.resume(at2) == 2
    first = fresh.train(sents, niters=1)
    assert len(resumed) == 1
    assert float(resumed[0]) == float(first[0])
    assert float(resumed[0]) != float(unkilled[2])


# ---------------------------------------------------------------------------
# the elastic world and the serve fleet, the port's children on the CPU

def _elastic_drill(d):
    """3 elastic ranks, rank 2 SIGKILLed at step 8 and readmitted."""
    env = {"SMTPU_FAULT_PLAN": FaultPlan().kill_rank(
               2, at_step=8, marker=str(d / "kill_marker")).to_json(),
           "SMTPU_FLEET_STEPS": "40", "SMTPU_FLEET_STEP_S": "0.03",
           "SMTPU_FLEET_HB_S": "0.25", "SMTPU_ELASTIC": "1",
           "SMTPU_ELASTIC_DUMP_EVERY": "3"}
    res = _launch(["-np", "3", "-elastic", "1", "-fleet-dir", str(d),
                   "-max-restarts", "3", "-backoff", "0.2", "-join-timeout",
                   "30", "-dead-after", "6", "--", sys.executable, "-m",
                   "swiftmpi_tpu_torch.testing.fleet_child", "-device",
                   "cpu"], env)
    fc = FleetCollector(str(d), stall_after_s=0.8, dead_after_s=3.2)
    fc.poll(final=True)
    return res, d, fc


def test_elastic_world_reconverges(elastic_world):
    """``fleet_smoke.py --elastic``'s checks on the port: the epoch
    reaches 2 (the death and a committed rejoin), the kill is organic,
    no death unnoticed, no rank killed as hung, every rank exits 0, every
    key in exactly one live census, reconvergence, migration bytes, the
    rows on the CPU."""
    res, d, fc = elastic_world
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    s = fc.summary()
    assert s["fleet_epoch"] >= 2
    epochs = [e for e in fc.supervisor_events if e["kind"] == "epoch"]
    assert [e["reason"] for e in epochs[:2]] == ["init", "death:r2"]
    assert any(str(e["reason"]).startswith("commit") for e in epochs)
    organic = [e for e in fc.supervisor_events if e["kind"] == "exit"
               and e["rank"] == 2 and e["rc"] not in (0, None)
               and not e["by_supervisor"]]
    assert [e["rc"] for e in organic] == [137]
    assert s["unnoticed_deaths"] == []
    # -dead-after judges each life on its own stream: the restarted rank
    # is not killed as hung before its first heartbeat
    assert not [e for e in fc.supervisor_events if e["kind"] == "hang_kill"]
    assert set(s["health"].values()) == {"exited"} and len(s["health"]) == 3
    assert s["fleet_reconverge_steps"] is not None
    assert s["migration_bytes"] > 0
    assert s["restarts"] == {"0": 0, "1": 0, "2": 1}
    keys = []
    for r in range(3):
        census = json.loads((d / f"census_r{r}.json").read_text())
        assert census["epoch"] == s["fleet_epoch"]
        keys += census["keys"]
    assert sorted(keys) == list(range(12 * 32))
    ok = [ln for ln in res.stdout.splitlines() if "ELASTIC_CHILD_OK" in ln]
    assert len(ok) == 3 and all("device=cpu" in ln for ln in ok)


def test_elastic_child_fails_loudly_without_a_whole_world(tmp_path):
    """The child's loop with a world that never becomes whole: 2 ranks
    expected, a committed table with rank 0 alone.  Once its step budget
    is spent and its join timeout has passed it exits 5 and names the
    cause on stderr (its step, the table's epoch, state and live ranks),
    with no ``ELASTIC_CHILD_OK``."""
    from swiftmpi_tpu_torch.cluster import membership as mem
    mem.write_membership(str(tmp_path), mem.initial_table(1, 4))
    env = dict(os.environ, SMTPU_ELASTIC="1", SMTPU_FLEET_DIR=str(tmp_path),
               SMTPU_NUM_PROCESSES="2", SMTPU_PROCESS_ID="0",
               SMTPU_ELASTIC_JOIN_TIMEOUT_S="1", SMTPU_FLEET_STEPS="3",
               SMTPU_FLEET_STEP_S="0.01", SMTPU_ELASTIC_SHARDS="4",
               SMTPU_ELASTIC_ROWS="8")
    res = subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.testing.fleet_child",
         "-device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 5, res.stdout + res.stderr
    assert "ELASTIC_CHILD_OK" not in res.stdout
    assert ("elastic_child: rank 0 stopped after" in res.stderr
            and "without a whole world" in res.stderr
            and "epoch 0 is committed with live ranks [0] of 2"
            in res.stderr), res.stderr


def _scripted_child(monkeypatch, tmp_path, steps, published, on_sync=None):
    """``fleet_child.elastic_main`` as rank 0 of 2 over a stand-in worker
    whose n-th sync adopts ``published(n)`` = (epoch, live ranks), a
    committed table, and calls ``on_sync(n)``; returns its rc, stdout and
    every census it wrote."""
    from swiftmpi_tpu_torch import obs
    from swiftmpi_tpu_torch.cluster import elastic
    from swiftmpi_tpu_torch.cluster.membership import COMMITTED
    from swiftmpi_tpu_torch.testing import fleet_child
    census = []

    class Worker:
        def __init__(self, rank, fleet_dir, **kw):
            self.dim, self.epoch, self.migration_bytes = kw["dim"], 0, 0
            self.n_owned, self.rows = 4, torch.zeros(1)
            self.member_table, self.syncs = None, 0

        def boot(self, timeout_s):
            self.sync()
            return True

        def sync(self):
            self.syncs += 1
            self.epoch, live = published(self.syncs)
            self.member_table = SimpleNamespace(
                state=COMMITTED, live=live, epoch=self.epoch)
            if on_sync is not None:
                on_sync(self.syncs)
            return []

        def step(self):
            return 0.5

        def write_census(self):
            census.append(self.epoch)

    monkeypatch.setattr(elastic, "ElasticWorker", Worker)
    monkeypatch.setenv("SMTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("SMTPU_ELASTIC_JOIN_TIMEOUT_S", "30")
    rec = SimpleNamespace(heartbeat=lambda: None, close=lambda: None)
    rc = fleet_child.elastic_main(rec, obs.get_registry(), 0, steps, 0.0,
                                  str(tmp_path), device="cpu")
    return rc, census


def test_elastic_child_sees_a_death_published_during_its_last_step(
        monkeypatch, tmp_path, capsys):
    """The child judges its world whole on the published table once its
    budget is spent: a death published during its last step (after that
    step's sync) keeps it stepping until the rejoin commits, and its
    census is the rejoined epoch's, not the stale one it last adopted (a
    stale census at epoch 0 against a fleet at 2 is how the drill failed
    under load)."""
    steps = 3
    (tmp_path / "done_r1").touch()            # the peer spent its budget

    def published(n):
        # whole at epoch 0 through boot and the budget's syncs, rank 1
        # dead at epoch 1 from the budget check on, whole at 2 later
        if n <= 1 + steps:
            return 0, (0, 1)
        return (1, (0,)) if n <= 1 + steps + 4 else (2, (0, 1))
    rc, census = _scripted_child(monkeypatch, tmp_path, steps, published)
    out = capsys.readouterr().out
    assert rc == 0 and "ELASTIC_CHILD_OK rank=0" in out and "epoch=2" in out
    assert census[-1] == 2 and (tmp_path / "done_r0").exists()


def test_elastic_child_waits_for_every_live_rank_to_spend_its_budget(
        monkeypatch, tmp_path, capsys):
    """A whole world is not enough to leave: a live peer still short of
    its budget (no ``done_r1`` yet) keeps the child stepping, since a
    rank that left could not hand rows back to that peer if it died and
    rejoined.  An earlier life's marker of this rank is removed at
    start."""
    steps, seen = 3, {}
    (tmp_path / "done_r0").touch()            # a predecessor's marker

    def on_sync(n):
        seen.setdefault("own_at_boot", (tmp_path / "done_r0").exists())
        if n == 12:
            (tmp_path / "done_r1").touch()
        seen["last"] = n
    rc, census = _scripted_child(monkeypatch, tmp_path, steps,
                                 lambda n: (0, (0, 1)), on_sync)
    assert rc == 0 and census[-1] == 0
    assert seen["own_at_boot"] is False
    assert seen["last"] >= 12


def _serve_drill(d):
    """A trainer and 2 replicas, replica 1 SIGKILLed at step 10."""
    env = {"SMTPU_FAULT_PLAN": FaultPlan().kill_rank(
               1, at_step=10, marker=str(d / "kill_marker")).to_json(),
           "SMTPU_SERVE_STEPS": "30", "SMTPU_SERVE_STEP_S": "0.05",
           "SMTPU_FLEET_HB_S": "0.25", "SMTPU_SERVE_EVERY": "4",
           "SMTPU_SERVE_VOCAB": "2048"}
    res = _launch(["-serve", "2", "-fleet-dir", str(d), "-max-restarts",
                   "3", "-backoff", "0.2", "--", sys.executable, "-m",
                   "swiftmpi_tpu_torch.testing.serve_child", "-device",
                   "cpu"], env)
    fc = FleetCollector(str(d), stall_after_s=0.8, dead_after_s=3.2)
    fc.poll(final=True)
    return res, d, fc


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every launch drill of this file, run once and side by side: the
    restart-the-world drills of both packages, the elastic world, the
    serve fleet and the start-up hang."""
    from concurrent.futures import ThreadPoolExecutor
    drills = {"restart": _restart_drills, "elastic": _elastic_drill,
              "serve": _serve_drill, "hang": _hang_drill}
    with ThreadPoolExecutor(len(drills)) as pool:
        futures = {k: pool.submit(fn, tmp_path_factory.mktemp(k))
                   for k, fn in drills.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture
def restart_world(worlds):
    return worlds["restart"]


@pytest.fixture
def elastic_world(worlds):
    return worlds["elastic"]


@pytest.fixture
def serve_world(worlds):
    return worlds["serve"]


def _replica_versions(members, key):
    out = []
    for st in members[key]["_streams"]:
        out.append([int(v) for r in st.records
                    for g, v in (r.get("gauges") or {}).items()
                    if parse_series_key(g)[0] == "serve/replica_version"])
    return out


def test_serve_fleet_resyncs_a_killed_replica(serve_world):
    """``fleet_smoke.py --serve``'s checks on the port: every replica
    life's versions monotone, the killed replica restarted and replayed
    to the manifest tail, the kill attributed, no death unnoticed."""
    res, d, fc = serve_world
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    s, sv = fc.summary(), fc.serve_view()
    manifest = read_manifest(str(d / "ship"))
    assert manifest and manifest[0]["kind"] == "full"
    assert sv["serve_replicas"] == 2
    assert s["unnoticed_deaths"] == []
    assert set(s["health"].values()) == {"exited"}
    members = fc.members()
    for r in ("1", "2"):
        for vals in _replica_versions(members, r):
            assert vals == sorted(vals)
    lives = _replica_versions(members, "1")
    assert len(lives) == 2
    assert manifest[-1]["version"] == 7          # 30 steps, a ship every 4
    assert max(lives[1]) >= manifest[-1]["version"]
    events = fc.supervisor_events
    assert [(e["rc"], e["role"]) for e in events if e["kind"] == "exit"
            and e["rank"] == 1 and not e["by_supervisor"]
            and e["rc"] != 0] == [(137, "replica")]
    assert any(e["kind"] == "restart_rank" and e["rank"] == 1
               for e in events)
    assert "SERVE_CHILD_OK role=trainer rank=0" in res.stdout
    assert "device=cpu" in res.stdout


@pytest.mark.parametrize("world", ["elastic_world", "serve_world",
                                   "restart_world"])
def test_both_collectors_agree_on_the_port_fleet(world, request):
    """The JAX package's FleetCollector reads the port-written fleet
    directory as the port's does: summary and health equal."""
    got = request.getfixturevalue(world)
    d = got["port", "killed"][1] / "fleet" if world == "restart_world" \
        else got[1]
    a, b = FleetCollector(str(d)), JaxCollector(str(d))
    a.poll(final=True)
    b.poll(final=True)
    assert a.health() == b.health()
    assert json.dumps(a.summary(), sort_keys=True, default=str) \
        == json.dumps(b.summary(), sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# the serve trainer's device update against the JAX child's numpy update

def _jax_serve_child():
    spec = importlib.util.spec_from_file_location(
        "_jax_serve_child", REPO / "scripts" / "_serve_child.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Closed:
    def close(self):
        pass


def test_serve_trainer_ships_what_the_jax_trainer_ships(tmp_path,
                                                        monkeypatch):
    """Both trainers in this process, the port's planes as CPU tensors:
    the same shipped versions, every payload's arrays equal (so the
    planes equal the numpy planes bit for bit at every publish)."""
    from swiftmpi_tpu_torch.testing import serve_child
    for k, v in {"SMTPU_SERVE_VOCAB": "1024", "SMTPU_SERVE_DIM": "8",
                 "SMTPU_SERVE_NHOT": "64", "SMTPU_SERVE_EVERY": "3",
                 "SMTPU_SERVE_TOUCH": "96"}.items():
        monkeypatch.setenv(k, v)
    jc = _jax_serve_child()
    dj, dp = tmp_path / "jax", tmp_path / "port"
    assert jc.trainer_main(_Closed(), None, 0, 10, 0.0, str(dj)) == 0
    assert serve_child.trainer_main(_Closed(), None, 0, 10, 0.0, str(dp),
                                    device="cpu") == 0
    mj, mp = read_manifest(str(dj)), read_manifest(str(dp))
    assert len(mp) == len(mj) == 3
    drop = ("ts", "ship_ms")
    assert [{k: v for k, v in r.items() if k not in drop} for r in mp] \
        == [{k: v for k, v in r.items() if k not in drop} for r in mj]
    for r in mj:
        name = f"ship_v{r['version']}.npz"
        with np.load(dj / name) as zj, np.load(dp / name) as zp:
            assert sorted(zj.files) == sorted(zp.files)
            for f in zj.files:
                np.testing.assert_array_equal(zp[f], zj[f])
