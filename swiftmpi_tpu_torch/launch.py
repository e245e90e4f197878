"""Single-host multi-process launcher and supervisor: the ``mpirun -np
N`` equivalent (counterpart of ``swiftmpi_tpu/launch.py``).

The reference is launched as ``mpirun -np N ./bin/word2vec -config ...
-data ...`` (reference apps/word2vec/cluster_run.sh:2).  Here::

    python -m swiftmpi_tpu_torch.launch -np 2 -- python -m \\
        swiftmpi_tpu_torch.apps.w2v_main -config demo.conf -data corpus.txt

spawns N local processes wired to one ``torch.distributed`` store (the
environment contract of ``cluster/bootstrap.py``); each child joins the
gloo process group through ``Cluster.initialize()``.  On one card every
child uses the same device: nothing splits ``CUDA_VISIBLE_DEVICES``.  The
launcher chooses no device: a child's ``-device cpu`` reaches it as
written.

Flags (reference CMDLine style, ``-key value``):

* ``-np N``       — number of processes (default 1).
* ``-port P``     — the store's port (default: an OS-assigned free port,
                    a fresh one for every restart attempt).
* ``-max-restarts R`` — supervised mode: on any non-zero world exit,
                    restart ALL ranks from scratch up to R times with
                    exponential backoff (restart-the-world; the child
                    resumes from its checkpoint, e.g. ``w2v_main
                    -checkpoint``, which runs ``train_with_resume``).
* ``-backoff S``  — initial restart backoff seconds (default 1.0,
                    doubling per restart, capped at 60 s).
* ``-stable-after S`` — reset the restart budget after the world (or, in
                    elastic and serve mode, the rank) ran S seconds
                    before failing: ``max_restarts`` bounds crash loops,
                    not the organic hiccups of a long run.
* ``-elastic 1``  — per-rank failure domains: one rank dying is
                    repartitioned across the survivors and restarted
                    alone instead of tearing the world down
                    (:func:`supervise_elastic`); requires ``-fleet-dir``.
                    ``-shards K``, ``-join-timeout S``, ``-dead-after S``
                    tune the member table, the rejoin deadline and
                    hung-rank detection.
* ``-serve N``    — serve fleet: rank 0 is the trainer, ranks 1..N are
                    replica readers replaying the delta-shipped snapshot
                    stream in ``-ship-dir`` (default ``<fleet-dir>/ship``)
                    (:func:`supervise_serve`).  ``-trainer-restarts R``
                    budgets the trainer apart.  Requires ``-fleet-dir``.
* ``-fleet-dir D`` — fleet observability: children get
                    ``SMTPU_FLEET_DIR=D`` (their StepRecorder writes a
                    heartbeat'd ``telemetry_r<rank>_p<pid>.jsonl`` stream
                    there, ``obs.configure``) and the launcher appends its
                    own ``smtpu-fleet-sup/1`` events to
                    ``D/supervisor.jsonl``: spawn and exit (with the
                    normalised rc and a ``by_supervisor`` flag that tells
                    organic deaths from teardown kills), restart,
                    world_start and world_exit.
* ``-profile-at N`` — pre-arm a triggered profiler window on EVERY rank:
                    children get ``SMTPU_PROFILE_AT=N``
                    (``obs/profiler.py``); ``-profile-steps K`` sets its
                    length (``SMTPU_PROFILE_STEPS``).

The JAX launcher's ``-cpu D`` gives each child D virtual XLA devices,
which has no torch meaning: it is refused.

Children's output comes through with a ``[rank k]`` line prefix.  The
first non-zero exit terminates the rest (mpirun semantics): survivors get
SIGTERM, then SIGKILL after a grace period, every child is reaped, and
the readers are drained before :func:`launch` returns, so no child is
left behind.  The first failure's exit code is the launcher's; signal
deaths map to the shell convention ``128 + signum``.  A child blocked in
a device sync or a gloo wait does not run its SIGTERM handler; it meets
the SIGKILL and is logged ``by_supervisor``, never as an organic death.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from swiftmpi_tpu_torch.cluster.bootstrap import (ENV_COORDINATOR,
                                                  ENV_FLEET_DIR,
                                                  ENV_NUM_PROCESSES,
                                                  ENV_PROCESS_ID)

#: role environment variable the serve-fleet children read: "trainer" or
#: "replica"
ENV_SERVE_ROLE = "SMTPU_SERVE_ROLE"
#: the snapshot ship directory (``serve/shipper.py``'s stream) of both
#: roles
ENV_SHIP_DIR = "SMTPU_SHIP_DIR"
#: seconds an elastic rank may take, beyond ``-dead-after``, from its
#: spawn to its first heartbeat: a child imports torch and brings the
#: card up first, several at once on one host
START_GRACE_S = 30.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(base: Dict[str, str], port: int, rank: int, nprocs: int,
               fleet_dir: Optional[str] = None) -> Dict[str, str]:
    env = dict(base)
    env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
    env[ENV_NUM_PROCESSES] = str(nprocs)
    if fleet_dir:
        env[ENV_FLEET_DIR] = fleet_dir
    # besides the process-group rank, the identity every log line and
    # telemetry record carries ("r<rank>", obs/identity.py)
    env[ENV_PROCESS_ID] = str(rank)
    return env


def _normalize_rc(code: int) -> int:
    """Child exit code -> process exit code.  Popen reports signal
    deaths as negative numbers; map them to the shell convention 128 +
    signum (SIGKILL -> 137)."""
    return 128 - code if code < 0 else code


def _reader(print_lock: threading.Lock):
    """A pump of one child's output into ours, line by line, prefixed."""
    def pump(rank: int, stream) -> None:
        try:
            for line in stream:
                with print_lock:
                    sys.stdout.write(f"[rank {rank}] {line}")
                    sys.stdout.flush()
        except (ValueError, OSError):
            pass     # stream closed by the teardown while blocked
    return pump


class _Ranks:
    """The children of one supervisor: spawn with the output pumped and a
    ``spawn`` event, exactly one ``exit`` event for every child, and the
    kill -> reap -> drain teardown.  With ``budget_of`` (rank -> restart
    budget) each rank is a failure domain of its own, restarted under its
    budget and backoff or abandoned (the elastic and serve supervisors);
    without it the ranks are one world whose first failure is its rc
    (:func:`launch`)."""

    def __init__(self, argv: List[str], nprocs: int, port: int,
                 fleet_dir: Optional[str], fleet_log, kill_grace_s: float,
                 budget_of=None, backoff=(0.5, 2.0, 30.0),
                 stable_after_s: Optional[float] = None, labels=None,
                 env_of=None, attempt: int = 0):
        self.argv, self.nprocs, self.port = argv, nprocs, port
        self.fleet_dir, self.fleet_log = fleet_dir, fleet_log
        self.kill_grace_s = kill_grace_s
        self.budget_of = budget_of
        #: (initial seconds, factor, cap)
        self.backoff = backoff
        self.stable_after_s = stable_after_s
        self.labels = labels or (lambda rank: {})
        self.env_of = env_of or (lambda rank: {})
        self.procs: Dict[int, subprocess.Popen] = {}
        #: every life's output pump and process, for the drain
        self.lives: List[tuple] = []
        self.attempts: Dict[int, int] = {r: attempt for r in range(nprocs)}
        self.last_start: Dict[int, float] = {}
        self.restart_due: Dict[int, float] = {}
        self.finished: set = set()
        self.abandoned: set = set()
        self.terminated: set = set()       # ranks we delivered a signal to
        self.rc = 0                        # the first failure's
        self._reader = _reader(threading.Lock())

    def _event(self, kind: str, **fields) -> None:
        if self.fleet_log is not None:
            self.fleet_log.event(kind, **fields)

    @property
    def running(self) -> bool:
        return bool(self.procs or self.restart_due)

    def spawn(self, rank: int) -> None:
        env = _child_env(os.environ, self.port, rank, self.nprocs,
                         self.fleet_dir)
        env.update(self.env_of(rank))
        p = subprocess.Popen(self.argv, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        self.procs[rank] = p
        self.last_start[rank] = time.monotonic()
        self._event("spawn", rank=rank, pid=p.pid, **self.labels(rank),
                    attempt=self.attempts[rank])
        t = threading.Thread(target=self._reader, args=(rank, p.stdout),
                             daemon=True)
        t.start()
        self.lives.append((t, p))

    def note_exit(self, rank: int, p, code: int) -> None:
        self._event("exit", rank=rank, pid=p.pid, rc=_normalize_rc(code),
                    **self.labels(rank),
                    by_supervisor=rank in self.terminated,
                    attempt=self.attempts[rank])
        self.terminated.discard(rank)

    def kill(self, rank: int) -> None:
        self.terminated.add(rank)
        self.procs[rank].kill()

    def reap(self, now: float, on_death=None) -> None:
        """Reap the exits of one poll round.  One world: the first
        failure sets ``rc``.  Per-rank failure domains: the exit event,
        the stable-period budget reset, the membership half
        (``on_death``), then a restart under the rank's backoff or its
        abandonment."""
        for rank, p in list(self.procs.items()):
            code = p.poll()
            if code is None:
                continue
            self.note_exit(rank, p, code)
            del self.procs[rank]
            if code == 0:
                self.finished.add(rank)
                continue
            rcn = _normalize_rc(code)
            if self.budget_of is None:
                self.rc = self.rc or rcn
                continue
            ran_s = now - self.last_start[rank]
            if self.stable_after_s is not None and self.attempts[rank] \
                    and ran_s >= self.stable_after_s:
                self._event("stable_reset", rank=rank, ran_s=ran_s,
                            attempt=self.attempts[rank])
                self.attempts[rank] = 0
            if on_death is not None:
                on_death(rank)
            budget = self.budget_of(rank)
            if self.attempts[rank] >= budget:
                role = self.labels(rank).get("role")
                print(f"[launch] {'serve ' + role + ' ' if role else ''}"
                      f"rank {rank} out of restart budget ({budget}); "
                      f"abandoned rc={rcn}", file=sys.stderr)
                self._event("rank_abandoned", rank=rank,
                            **self.labels(rank), rc=rcn)
                self.abandoned.add(rank)
                self.rc = self.rc or rcn
            else:
                first, factor, cap = self.backoff
                delay = min(first * factor ** self.attempts[rank], cap)
                self.attempts[rank] += 1
                self._event("restart_rank", rank=rank, **self.labels(rank),
                            rc=rcn, attempt=self.attempts[rank],
                            delay_s=delay)
                self.restart_due[rank] = now + delay

    def respawn_due(self, now: float) -> None:
        for rank, due in list(self.restart_due.items()):
            if now >= due:
                del self.restart_due[rank]
                self.spawn(rank)

    def world_exit(self) -> int:
        self._event("world_exit", rc=self.rc, finished=sorted(self.finished),
                    abandoned=sorted(self.abandoned))
        return self.rc

    def teardown(self, term_grace_s: float = 0.0) -> None:
        """Kill -> reap -> drain: nothing survives, success or raise.
        ``term_grace_s`` > 0 sends SIGTERM first and SIGKILL to what is
        still alive that many seconds later.  Every kill needs a wait or
        the child stays a zombie; a reader blocked on a pipe a grandchild
        still holds is unblocked by closing the pipe."""
        alive = [(r, p) for r, p in self.procs.items() if p.poll() is None]
        for rank, p in alive:
            self.terminated.add(rank)
            if term_grace_s > 0:
                p.terminate()
            else:
                p.kill()
        if term_grace_s > 0:
            deadline = time.monotonic() + term_grace_s
            for _, p in alive:
                try:
                    p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()                       # SIGTERM ignored
        for rank, p in self.procs.items():
            try:
                p.wait(timeout=self.kill_grace_s)
            except subprocess.TimeoutExpired:
                pass               # unkillable (D-state); nothing to do
            self.note_exit(rank, p, p.poll() if p.poll() is not None
                           else -9)
        self.procs.clear()
        for t, _ in self.lives:
            t.join(timeout=2.0)
        for t, p in self.lives:
            if t.is_alive():
                try:
                    p.stdout.close()
                except (ValueError, OSError):
                    pass
        for t, _ in self.lives:
            t.join(timeout=1.0)


def launch(argv: List[str], nprocs: int, port: int = 0,
           kill_grace_s: float = 5.0, fleet_dir: Optional[str] = None,
           fleet_log=None, attempt: int = 0) -> int:
    """Spawn ``nprocs`` copies of ``argv`` under one store; returns the
    first non-zero child exit code (terminating the others), else 0.

    One world of :class:`_Ranks` with no per-rank restarts: one reader
    thread per child (a blocking ``readline`` there cannot stall exit
    detection here) while this thread polls exit codes; the first failure
    tears the world down, SIGTERM escalating to SIGKILL after
    ``kill_grace_s``, kill -> reap -> drain, so no child is left behind.

    ``fleet_log`` (a :class:`~swiftmpi_tpu_torch.obs.collector.
    SupervisorLog`, owned by :func:`supervise` so it spans restarts)
    receives one ``spawn`` per child and exactly one ``exit`` per child;
    ``by_supervisor`` tells the ranks this teardown killed from the rank
    that died on its own."""
    port = port or _free_port()
    own_log = bool(fleet_dir) and fleet_log is None
    if own_log:
        from swiftmpi_tpu_torch.obs.collector import SupervisorLog
        fleet_log = SupervisorLog(fleet_dir)
    ranks = _Ranks(argv, nprocs, port, fleet_dir, fleet_log, kill_grace_s,
                   budget_of=None, attempt=attempt)
    try:
        for rank in range(nprocs):
            ranks.spawn(rank)
        while ranks.procs and not ranks.rc:
            time.sleep(0.1)
            ranks.reap(time.monotonic())
        return ranks.rc
    finally:
        ranks.teardown(term_grace_s=kill_grace_s)
        if own_log:
            fleet_log.close()


def supervise(argv: List[str], nprocs: int, port: int = 0,
              kill_grace_s: float = 5.0, max_restarts: int = 0,
              backoff_s: float = 1.0, backoff_factor: float = 2.0,
              backoff_max_s: float = 60.0,
              fleet_dir: Optional[str] = None,
              stable_after_s: Optional[float] = None) -> int:
    """Restart-the-world supervisor around :func:`launch`.

    A failed rank cannot be patched back into a running world (its peers
    are blocked in collectives and exchanges with it), so ANY non-zero
    world exit tears everything down and relaunches all ranks, which
    resume from the last valid checkpoint when the child uses
    ``train_with_resume``.  Restarts are bounded (``max_restarts``) with
    exponential backoff, so a deterministic crash loop exhausts its budget
    and surfaces the real exit code.  With the default ``port=0`` every
    attempt picks a fresh store port: the new world builds its process
    group and its cross-process rings anew, and nothing of the dead
    world's store or IPC handles is reused.

    With ``fleet_dir``, ONE SupervisorLog spans every attempt: restart
    events land between the attempts' spawn/exit runs, so the collector
    sees a rank's pre- and post-restart lives as one member history.

    ``stable_after_s`` resets the restart counter after the world ran that
    long before failing: only failures in quick succession burn the
    budget."""
    attempt = 0
    fleet_log = None
    if fleet_dir:
        from swiftmpi_tpu_torch.obs.collector import SupervisorLog
        fleet_log = SupervisorLog(fleet_dir)
        fleet_log.event("world_start", nprocs=nprocs,
                        max_restarts=max_restarts, argv=list(argv))
    try:
        while True:
            t_start = time.monotonic()
            rc = launch(argv, nprocs, port, kill_grace_s,
                        fleet_dir=fleet_dir, fleet_log=fleet_log,
                        attempt=attempt)
            ran_s = time.monotonic() - t_start
            if rc != 0 and attempt and stable_after_s is not None \
                    and ran_s >= stable_after_s:
                print(f"[launch] world was stable {ran_s:.1f}s >= "
                      f"{stable_after_s:.1f}s; restart budget reset",
                      file=sys.stderr)
                if fleet_log is not None:
                    fleet_log.event("stable_reset", ran_s=ran_s,
                                    attempt=attempt)
                attempt = 0
            if rc == 0:
                if attempt:
                    print(f"[launch] world recovered after {attempt} "
                          f"restart(s)", file=sys.stderr)
                if fleet_log is not None:
                    fleet_log.event("world_exit", rc=0, attempt=attempt)
                return 0
            if attempt >= max_restarts:
                if max_restarts:
                    print(f"[launch] restart budget exhausted "
                          f"({max_restarts}); giving up with rc={rc}",
                          file=sys.stderr)
                if fleet_log is not None:
                    fleet_log.event("world_exit", rc=rc, attempt=attempt)
                return rc
            delay = min(backoff_s * (backoff_factor ** attempt),
                        backoff_max_s)
            attempt += 1
            print(f"[launch] world failed rc={rc}; restart "
                  f"{attempt}/{max_restarts} in {delay:.1f}s",
                  file=sys.stderr)
            if fleet_log is not None:
                fleet_log.event("restart", rc=rc, attempt=attempt,
                                delay_s=delay)
            time.sleep(delay)
    finally:
        if fleet_log is not None:
            fleet_log.close()


def _publish_epoch(fleet_dir: str, table, fleet_log, reason: str) -> None:
    """The supervisor's ONLY membership-write path: publish a new member
    table (``membership.write_membership`` refuses an epoch that does not
    advance) and put the epoch transition on the fleet timeline in the
    same breath, so the collector can correlate every ownership change
    with the supervisor evidence that caused it."""
    from swiftmpi_tpu_torch.cluster import membership as mem
    # epoch-guard: mem.write_membership validates the epoch advance
    # (same-epoch rewrites other than prepare->commit raise
    # StaleEpochError): every supervisor-side table write goes through
    # that check exactly once
    mem.write_membership(fleet_dir, table)
    if fleet_log is not None:
        fleet_log.event("epoch", epoch=table.epoch, state=table.state,
                        live=list(table.live), reason=reason,
                        moves=len(table.moves))


def _handback_shards(table, weight: List[float], k: int) -> List[int]:
    """Pick ``k`` shards to hand back to a rejoining rank: repeatedly
    take the heaviest shard from the currently most-loaded survivor, the
    inverse of the death path's LPT, so a rejoin undoes imbalance instead
    of adding to it."""
    owned = {r: sorted(table.shards_of(r), key=lambda s: -weight[s])
             for r in table.live}
    load = {r: sum(weight[s] for s in owned[r]) for r in table.live}
    picks: List[int] = []
    for _ in range(max(k, 0)):
        donors = [r for r in table.live if len(owned[r]) > 1]
        if not donors:       # never strip a survivor's last shard
            break
        r = max(donors, key=lambda r: (load[r], -r))
        s = owned[r].pop(0)
        load[r] -= weight[s]
        picks.append(s)
    return picks


def supervise_elastic(argv: List[str], nprocs: int, *, fleet_dir: str,
                      port: int = 0, kill_grace_s: float = 5.0,
                      max_restarts: int = 2, backoff_s: float = 0.5,
                      backoff_factor: float = 2.0,
                      backoff_max_s: float = 30.0,
                      stable_after_s: Optional[float] = None,
                      join_timeout_s: float = 20.0,
                      n_shards: Optional[int] = None,
                      dead_after_s: Optional[float] = None,
                      poll_s: float = 0.1) -> int:
    """Per-rank failure domains: the elastic alternative to
    :func:`supervise`'s restart-the-world.

    The supervisor owns the member table (``cluster/membership.py``) and
    is its only writer.  One rank dying does NOT tear the world down:

    1. the exit is reaped and logged (normalised rc, ``by_supervisor``);
    2. a two-phase rejoin in flight is rolled back first (``plan_death``
       refuses to operate over a PREPARE table: all or nothing);
    3. the dead rank's shards are repartitioned across the survivors with
       :func:`~swiftmpi_tpu_torch.control.controller.plan_placement` over
       the ranks' published DecayedSketch folds, and the new COMMITTED
       epoch is published; survivors adopt the orphans from the dead
       rank's last dump (staleness <= its dump cadence);
    4. the rank is restarted with per-RANK backoff (``stable_after_s``
       resets a rank's budget after a long stable run) and re-admitted
       through the two-phase prepare/commit rejoin when its join request
       arrives, or abandoned once its budget is spent, the world carrying
       on minus one failure domain.

    ``dead_after_s`` arms the detection half an exit code cannot see: a
    HUNG rank (alive, silent) is judged by FleetCollector health against
    the wall clock and killed, which routes it into the same death path.
    It needs the children to heartbeat through ``SMTPU_FLEET_DIR``
    telemetry.  A rank is judged on its current life's stream only: a
    restarted rank whose stream does not exist yet is not judged by its
    dead predecessor's (the JAX supervisor does, and kills every restart
    of a rank before it writes its first heartbeat).  A life with no
    stream yet is judged on its start-up instead: it is killed as hung
    once it has been silent ``dead_after_s + START_GRACE_S`` since its
    spawn.

    Returns 0 when every rank finished rc=0; else the first abandoned
    rank's rc (the world ran degraded, and says so)."""
    from swiftmpi_tpu_torch.cluster import membership as mem
    from swiftmpi_tpu_torch.control.controller import (plan_placement,
                                                       shard_weights)
    from swiftmpi_tpu_torch.obs.collector import (FleetCollector,
                                                  SupervisorLog)

    os.makedirs(fleet_dir, exist_ok=True)
    n_shards = n_shards or 4 * nprocs
    port = port or _free_port()
    table = mem.initial_table(nprocs, n_shards)
    fleet_log = SupervisorLog(fleet_dir)
    fleet_log.event("world_start", nprocs=nprocs, mode="elastic",
                    n_shards=n_shards, max_restarts=max_restarts,
                    argv=list(argv))
    _publish_epoch(fleet_dir, table, fleet_log, "init")
    ranks = _Ranks(argv, nprocs, port, fleet_dir, fleet_log, kill_grace_s,
                   lambda r: max_restarts,
                   (backoff_s, backoff_factor, backoff_max_s), stable_after_s)
    prepare_deadline: Optional[float] = None
    last_health_poll = 0.0

    def handle_death(rank: int) -> None:
        """Membership half of a rank failure: roll back any in-flight
        prepare, then repartition the dead rank's shards across the
        survivors and publish the new epoch."""
        nonlocal table, prepare_deadline
        if table.state == mem.PREPARE:
            table = mem.rollback_table(
                table, reason=f"rank {rank} died mid-prepare")
            _publish_epoch(fleet_dir, table, fleet_log, table.reason)
            prepare_deadline = None
        if rank not in table.live:
            return                   # was the rolled-back rejoiner
        if len(table.live) == 1:
            # the last live rank: nobody to repartition onto; its restart
            # resumes from its own dump, a world-of-one restart
            return
        dead_shards = table.shards_of(rank)
        survivors = [r for r in table.live if r != rank]
        assign = plan_placement(dead_shards, survivors,
                                mem.read_loads(fleet_dir, n_shards),
                                table.owner_of_shard)
        table = mem.plan_death(table, rank, assign)
        _publish_epoch(fleet_dir, table, fleet_log, table.reason)

    for rank in range(nprocs):
        ranks.spawn(rank)
    try:
        while ranks.running:
            now = time.monotonic()
            # 1. reap exits, each a per-rank failure domain
            ranks.reap(now, on_death=handle_death)
            # 2. spawn due restarts (they re-enter through a join request)
            ranks.respawn_due(now)
            # 3. drive an in-flight prepare to commit or rollback
            if table.state == mem.PREPARE:
                if mem.acks_complete(fleet_dir, table):
                    table = mem.commit_table(table)
                    _publish_epoch(fleet_dir, table, fleet_log,
                                   "commit: " + table.reason)
                    prepare_deadline = None
                elif prepare_deadline is not None \
                        and now >= prepare_deadline:
                    table = mem.rollback_table(table,
                                               reason="prepare timeout")
                    _publish_epoch(fleet_dir, table, fleet_log,
                                   table.reason)
                    prepare_deadline = None
            # 4. admit pending joins (only from a committed table)
            elif table.state == mem.COMMITTED:
                for rank, claimed in sorted(
                        mem.pending_joins(fleet_dir).items()):
                    if rank in table.live:
                        continue
                    verdict = mem.judge_join(table, rank, claimed)
                    if verdict == "stale":
                        mem.write_reject(
                            fleet_dir, rank,
                            reason=f"claimed epoch {claimed} is ahead "
                                   f"of the world's {table.epoch}")
                        mem.clear_join(fleet_dir, rank)
                        fleet_log.event("join_rejected", rank=rank,
                                        claimed=claimed,
                                        epoch=table.epoch)
                        continue
                    weight = shard_weights(
                        mem.read_loads(fleet_dir, n_shards), n_shards)
                    share = n_shards // (len(table.live) + 1)
                    picks = _handback_shards(table, weight, share)
                    assign = {s: rank for s in picks}
                    table = mem.plan_rejoin(table, rank, assign)
                    _publish_epoch(fleet_dir, table, fleet_log,
                                   table.reason)
                    prepare_deadline = time.monotonic() + join_timeout_s
                    break          # one prepare in flight at a time
            # 5. hung-rank detection: alive but silent past dead_after_s
            if dead_after_s and now - last_health_poll >= 1.0:
                last_health_poll = now
                coll = FleetCollector(fleet_dir, dead_after_s=dead_after_s)
                coll.poll()
                health = coll.health(at=time.time())
                lives = {}
                for key, m in coll.members().items():
                    try:
                        lives[int(key.lstrip("r"))] = (m["pids"][-1],
                                                       health[key])
                    except ValueError:
                        continue
                for hrank, p in list(ranks.procs.items()):
                    if p.poll() is not None:
                        continue
                    pid, status = lives.get(hrank, (None, None))
                    if pid == p.pid:
                        hung = status == "dead"
                    else:
                        # no stream of this life yet: its start-up is
                        # judged, not its dead predecessor's stream
                        hung = now - ranks.last_start[hrank] \
                            > dead_after_s + START_GRACE_S
                    if hung:
                        print(f"[launch] rank {hrank} hung (silent > "
                              f"{dead_after_s:.1f}s); killing",
                              file=sys.stderr)
                        fleet_log.event("hang_kill", rank=hrank,
                                        pid=p.pid)
                        ranks.kill(hrank)
            time.sleep(poll_s)
        return ranks.world_exit()
    finally:
        ranks.teardown()
        fleet_log.close()


def supervise_serve(argv: List[str], n_replicas: int, *, fleet_dir: str,
                    ship_dir: Optional[str] = None, port: int = 0,
                    kill_grace_s: float = 5.0, max_restarts: int = 2,
                    trainer_restarts: Optional[int] = None,
                    backoff_s: float = 0.5, backoff_factor: float = 2.0,
                    backoff_max_s: float = 30.0,
                    stable_after_s: Optional[float] = None,
                    poll_s: float = 0.1) -> int:
    """Serve-fleet supervisor: one trainer rank + N replica reader ranks
    over a shared snapshot-ship directory.

    Failure domains are per rank, with the elastic supervisor's budgets,
    but the roles are asymmetric the way serving wants:

    * a **replica** dying takes no write-path capacity with it: it
      restarts alone under its per-rank backoff budget and re-syncs by
      replaying the newest full base + deltas from the ship dir (the
      version chain IS the recovery path; no peer coordination);
    * the **trainer** dying does NOT tear the replicas down: they keep
      serving the last shipped version, stale but bounded (the replica's
      ``serve/staleness_s`` gauge rising), while the trainer restarts
      (its shipper resumes the version stream past the manifest tail,
      forced full) or is abandoned.

    Ranks: 0 = trainer, 1..N = replicas; children learn their role from
    ``SMTPU_SERVE_ROLE`` and the stream's place from ``SMTPU_SHIP_DIR``
    (default ``<fleet_dir>/ship``).  Returns 0 when every rank finished
    rc=0, else the first abandoned rank's rc."""
    from swiftmpi_tpu_torch.obs.collector import SupervisorLog

    nprocs = n_replicas + 1
    os.makedirs(fleet_dir, exist_ok=True)
    ship_dir = ship_dir or os.path.join(fleet_dir, "ship")
    os.makedirs(ship_dir, exist_ok=True)
    port = port or _free_port()
    if trainer_restarts is None:
        trainer_restarts = max_restarts
    fleet_log = SupervisorLog(fleet_dir)
    fleet_log.event("world_start", nprocs=nprocs, mode="serve_fleet",
                    n_replicas=n_replicas, ship_dir=ship_dir,
                    max_restarts=max_restarts,
                    trainer_restarts=trainer_restarts, argv=list(argv))

    def role_of(rank: int) -> dict:
        return {"role": "trainer" if rank == 0 else "replica"}

    ranks = _Ranks(argv, nprocs, port, fleet_dir, fleet_log, kill_grace_s,
                   lambda r: trainer_restarts if r == 0 else max_restarts,
                   (backoff_s, backoff_factor, backoff_max_s), stable_after_s,
                   labels=role_of,
                   env_of=lambda rank: {ENV_SERVE_ROLE: role_of(rank)["role"],
                                        ENV_SHIP_DIR: ship_dir})
    for rank in range(nprocs):
        ranks.spawn(rank)
    try:
        while ranks.running:
            now = time.monotonic()
            ranks.reap(now)
            ranks.respawn_due(now)
            time.sleep(poll_s)
        return ranks.world_exit()
    finally:
        ranks.teardown()
        fleet_log.close()


def main(args: Optional[List[str]] = None) -> int:
    from swiftmpi_tpu_torch.utils.cmdline import CMDLine

    if args is None:
        args = sys.argv[1:]
    if "--" not in args:
        print("usage: python -m swiftmpi_tpu_torch.launch -np N [-port P] "
              "[-max-restarts R] [-elastic 1 | -serve N] [-fleet-dir D] "
              "-- prog args...", file=sys.stderr)
        return 2
    split = args.index("--")
    cmd = CMDLine(["launch"] + args[:split])
    cmd.registerParameter("np", "number of processes")
    cmd.registerParameter("port", "the store's port")
    cmd.registerParameter("max-restarts",
                          "restart-the-world budget on failure")
    cmd.registerParameter("backoff", "initial restart backoff seconds")
    cmd.registerParameter("stable-after",
                          "reset the restart budget after this many stable "
                          "seconds")
    cmd.registerParameter("elastic",
                          "1 = per-rank failure domains: restart-the-rank "
                          "and cross-process repartition; requires "
                          "-fleet-dir")
    cmd.registerParameter("shards",
                          "elastic member-table shard count (default 4*np)")
    cmd.registerParameter("join-timeout",
                          "elastic rejoin prepare->commit deadline seconds")
    cmd.registerParameter("dead-after",
                          "elastic hung-rank detection: kill a rank silent "
                          "this many seconds")
    cmd.registerParameter("serve",
                          "serve fleet: N replica reader ranks beside one "
                          "trainer rank; requires -fleet-dir")
    cmd.registerParameter("ship-dir",
                          "snapshot ship directory (default "
                          "<fleet-dir>/ship)")
    cmd.registerParameter("trainer-restarts",
                          "serve-fleet trainer restart budget (default: "
                          "-max-restarts)")
    cmd.registerParameter("fleet-dir", "fleet telemetry directory")
    cmd.registerParameter("profile-at",
                          "pre-arm a profiler capture at step N on every "
                          "rank")
    cmd.registerParameter("profile-steps", "profiler capture window length")
    prog = args[split + 1:]
    if not prog:
        print("launch: nothing to run after --", file=sys.stderr)
        return 2
    if cmd.hasParameter("cpu"):
        print("launch: -cpu sets up virtual XLA devices, which has no torch "
              "meaning; pass -device cpu to the program instead",
              file=sys.stderr)
        return 2

    def value(flag: str, cast, default):
        return cast(cmd.get_value(flag)) if cmd.hasParameter(flag) \
            else default

    # the profiler pre-arm rides the inherited environment: _child_env
    # copies os.environ, so every rank of every restart attempt sees it
    if cmd.hasParameter("profile-at") or cmd.hasParameter("profile-steps"):
        from swiftmpi_tpu_torch.obs import profiler as obs_profiler
        if cmd.hasParameter("profile-at"):
            os.environ[obs_profiler.ENV_PROFILE_AT] = str(
                value("profile-at", int, 0))
        if cmd.hasParameter("profile-steps"):
            os.environ[obs_profiler.ENV_PROFILE_STEPS] = str(
                value("profile-steps", int, 0))
    nprocs = value("np", int, 1)
    port = value("port", int, 0)
    fleet_dir = value("fleet-dir", str, None)
    stable_after_s = value("stable-after", float, None)
    if value("serve", int, 0):
        if not fleet_dir:
            print("launch: -serve requires -fleet-dir (the supervisor log "
                  "and ship stream live there)", file=sys.stderr)
            return 2
        return supervise_serve(
            prog, value("serve", int, 0), fleet_dir=fleet_dir,
            ship_dir=value("ship-dir", str, None), port=port,
            max_restarts=value("max-restarts", int, 2),
            trainer_restarts=value("trainer-restarts", int, None),
            backoff_s=value("backoff", float, 0.5),
            stable_after_s=stable_after_s)
    if value("elastic", int, 0):
        if not fleet_dir:
            print("launch: -elastic requires -fleet-dir (the member table "
                  "and migration deltas live there)", file=sys.stderr)
            return 2
        return supervise_elastic(
            prog, nprocs, fleet_dir=fleet_dir, port=port,
            max_restarts=value("max-restarts", int, 2),
            backoff_s=value("backoff", float, 0.5),
            stable_after_s=stable_after_s,
            join_timeout_s=value("join-timeout", float, 20.0),
            n_shards=value("shards", int, None),
            dead_after_s=value("dead-after", float, None))
    return supervise(prog, nprocs=nprocs, port=port,
                     max_restarts=value("max-restarts", int, 0),
                     backoff_s=value("backoff", float, 1.0),
                     fleet_dir=fleet_dir, stable_after_s=stable_after_s)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
