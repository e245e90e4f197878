"""Fleet worker: a telemetry-armed step loop for the launcher's drills
(counterpart of the JAX package's ``scripts/_fleet_child.py``, whose
environment knobs and output lines it keeps).

    python -m swiftmpi_tpu_torch.launch -np 4 -fleet-dir D -- \\
        python -m swiftmpi_tpu_torch.testing.fleet_child [-device cpu]

The drills need children that exercise the per-rank telemetry surface
(step records, spans, wire counters, heartbeats, fault injection) while
needing nothing cross-process: no process group, no collectives.  Each
rank runs ``SMTPU_FLEET_STEPS`` steps of ``SMTPU_FLEET_STEP_S`` seconds
of (slept) dispatch work, booking rank-skewed wire traffic (rank r books
``1000 * (r + 1)`` bytes a step, so the fleet's ``wire_bytes_imbalance``
is deterministic and nonzero), and calls the fault bus at the top of
every step, where a launcher-installed ``SMTPU_FAULT_PLAN`` (hang and
kill drills) fires.  Telemetry lands in ``SMTPU_FLEET_DIR``
(``obs.configure``'s fleet redirect); the heartbeat cadence comes from
``SMTPU_FLEET_HB_S``.

``SMTPU_FLEET_NUMERICS=1`` also arms the numerics health plane with
synthetic per-rank gradient norms and a live AnomalyDetector;
``SMTPU_FLEET_NUMERICS_SPIKE=<step>`` injects a 40x grad-norm spike on
``SMTPU_FLEET_NUMERICS_SPIKE_RANK`` (default 0) at that step.
``SMTPU_FLEET_TRACE=1`` arms the wire tracer and drives it with one
synthetic window a step; rank 0 drops a ``trace_trigger.json`` mid-run
and every rank's tracer replays it into a dump in the fleet directory.

``SMTPU_ELASTIC=1`` switches the loop to an
:class:`~swiftmpi_tpu_torch.cluster.elastic.ElasticWorker` under
``launch.py -elastic 1``'s member table, its rows on the card (``-device
cpu`` puts them on the CPU): the child boots into the published
membership, syncs it at the top of every step (the safe point:
adoptions, two-phase rejoins and rollbacks all land here), trains its
owned rows, and publishes ``elastic/epoch``, ``elastic/loss`` and
``elastic/rows_owned`` gauges plus ``elastic/migration_bytes`` and
modeled ``transfer/wire_bytes`` counters.  ``SMTPU_ELASTIC_SHARDS``,
``_ROWS``, ``_DIM``, ``_DUMP_EVERY`` and ``_JOIN_TIMEOUT_S`` size it; a
rank evicted by a rollback re-enters through ``boot()``.
Unlike the JAX child, a rank keeps stepping past its step budget while
the world is not whole (until it adopts a committed table with every
rank live), for at most the join timeout: a drill then ends on the
evidence (the rejoin committed), not on how fast a restarted rank
started.  Once its budget is spent a rank writes ``done_r<rank>`` in
the fleet directory and leaves only when every live rank of the
published table has done so too (it syncs first, so a death published
during its last step keeps it in the loop): no rank leaves while a peer
it may have to hand rows back to is still short of its budget.  It prints
``ELASTIC_CHILD_OK rank=<r> steps=<n> epoch=<e> loss=<l> device=<d>
launches=<masked gather launches>`` on a clean finish; a stale-epoch
rejection exits rc 3, a rank never (re-)admitted rc 4, and a rank whose
join timeout passed without a whole world rc 5, with no census (each
loud on stderr, never silent).

The plain loop prints ``FLEET_CHILD_OK rank=<r> steps=<n>``.
"""

from __future__ import annotations

import os
import sys
import time

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.utils.config import ConfigParser


def _device(argv) -> str:
    """``-device cpu|cuda`` from the command line; None = the card."""
    if "-device" in argv:
        return argv[argv.index("-device") + 1]
    return None


def whole(worker, world: int) -> bool:
    """True once the worker adopted a committed table with all ``world``
    ranks live."""
    from swiftmpi_tpu_torch.cluster.membership import COMMITTED
    t = worker.member_table
    return t is not None and t.state == COMMITTED and len(t.live) == world


def done_path(fleet_dir: str, rank: int) -> str:
    """The marker a rank's life writes once it has spent its step
    budget."""
    return os.path.join(fleet_dir, f"done_r{rank}")


def all_done(worker, fleet_dir: str) -> bool:
    """True once every live rank of the adopted table has spent its step
    budget: a rank that left earlier could not ack a later rejoin."""
    return all(os.path.exists(done_path(fleet_dir, r))
               for r in worker.member_table.live)


def elastic_main(rec, reg, rank: int, steps: int, step_s: float,
                 fleet_dir: str, device=None) -> int:
    """Elastic step loop: ElasticWorker under the supervisor-owned member
    table (see the module docstring)."""
    from swiftmpi_tpu_torch.cluster.bootstrap import ENV_NUM_PROCESSES
    from swiftmpi_tpu_torch.cluster.elastic import ElasticWorker
    from swiftmpi_tpu_torch.cluster.membership import StaleEpochError
    from swiftmpi_tpu_torch.kernels import gather

    world = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    worker = ElasticWorker(
        rank, fleet_dir, world_size=world,
        n_shards=int(os.environ.get("SMTPU_ELASTIC_SHARDS",
                                    str(4 * world))),
        rows_per_shard=int(os.environ.get("SMTPU_ELASTIC_ROWS", "32")),
        dim=int(os.environ.get("SMTPU_ELASTIC_DIM", "8")),
        dump_every=int(os.environ.get("SMTPU_ELASTIC_DUMP_EVERY", "5")),
        device=device)
    # proof of life once the rows are on the device: bringing a device up
    # must not read as a hang to the supervisor's -dead-after
    rec.heartbeat()
    join_timeout = float(os.environ.get("SMTPU_ELASTIC_JOIN_TIMEOUT_S",
                                        "30"))
    row_bytes = 4 + worker.dim * 4
    booked_mig = 0
    loss = 0.0
    gather.launches = 0

    def safe_point() -> bool:
        """Adopt the published table; False when this rank was evicted
        and never re-admitted."""
        events = worker.sync()
        if any(e.get("kind") == "evicted" for e in events) \
                and not worker.boot(timeout_s=join_timeout):
            print(f"elastic_child: rank {rank} evicted and never "
                  "re-admitted", file=sys.stderr)
            return False
        return True

    # an earlier life's marker: this life has its budget still to spend
    if os.path.exists(done_path(fleet_dir, rank)):
        os.remove(done_path(fleet_dir, rank))
    try:
        if not worker.boot(timeout_s=join_timeout):
            print(f"elastic_child: rank {rank} never admitted within "
                  f"{join_timeout}s", file=sys.stderr)
            return 4
        step, deadline = 0, None
        while True:
            if step >= steps:
                if step == steps:
                    open(done_path(fleet_dir, rank), "w").close()
                # judged on the published table: the one adopted at the
                # top of the last step can hide a death published since,
                # and a rank leaving on it writes a stale census
                if not safe_point():
                    return 4
                if whole(worker, world) and all_done(worker, fleet_dir):
                    break
                deadline = deadline or time.monotonic() + join_timeout
                if time.monotonic() > deadline:
                    break
            faults.step_event(step)       # kill/hang drills fire here
            if not safe_point():          # the safe point
                return 4
            with obs.span("dispatch"):
                loss = worker.step()
                time.sleep(step_s)
            reg.gauge("elastic/epoch").set(float(worker.epoch))
            reg.gauge("elastic/loss").set(float(loss))
            reg.gauge("elastic/rows_owned").set(float(worker.n_owned))
            if worker.migration_bytes > booked_mig:
                reg.counter("elastic/migration_bytes").inc(
                    worker.migration_bytes - booked_mig)
                booked_mig = worker.migration_bytes
            # modeled per-step training wire: owned rows x sparse row
            # bytes, what feeds the fleet's wire imbalance
            reg.counter("transfer/wire_bytes", backend="elastic").inc(
                worker.n_owned * row_bytes)
            reg.counter("transfer/dispatches", backend="elastic").inc(1)
            obs.record_step(1)
            step += 1
    except StaleEpochError as e:
        print(f"elastic_child: STALE EPOCH on rank {rank}: {e}",
              file=sys.stderr)
        return 3
    if not (whole(worker, world) and all_done(worker, fleet_dir)):
        # the join deadline passed first: a census now would report a
        # world that never converged as a finished one
        t = worker.member_table
        done = [r for r in t.live if os.path.exists(done_path(fleet_dir, r))]
        print(f"elastic_child: rank {rank} stopped after {step} steps "
              f"without a whole world: {join_timeout}s past its step "
              f"budget the table at epoch {worker.epoch} is {t.state} "
              f"with live ranks {sorted(t.live)} of {world}, those past "
              f"their budgets {done}", file=sys.stderr)
        return 5
    worker.write_census()
    rec.close()
    print(f"ELASTIC_CHILD_OK rank={rank} steps={step} "
          f"epoch={worker.epoch} loss={loss:.6f} "
          f"device={worker.rows.device.type} launches={gather.launches}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    steps = int(os.environ.get("SMTPU_FLEET_STEPS", "60"))
    step_s = float(os.environ.get("SMTPU_FLEET_STEP_S", "0.02"))
    hb_s = float(os.environ.get("SMTPU_FLEET_HB_S", "0.25"))
    fleet_dir = os.environ.get("SMTPU_FLEET_DIR", "")
    trace = os.environ.get("SMTPU_FLEET_TRACE", "0") not in ("", "0")

    obs_cfg = {"heartbeat_s": hb_s}
    if trace:
        # dumps land next to the telemetry streams
        obs_cfg.update({"trace": 1, "trace_dir": fleet_dir or "runs"})
    cfg = ConfigParser().update({
        "worker": {"telemetry": 1},
        "obs": obs_cfg,
    })
    rec = obs.configure(cfg, run="fleet_child")
    if rec is None:
        print("fleet_child: telemetry failed to arm", file=sys.stderr)
        return 2
    rank = obs.process_rank() or 0
    reg = obs.get_registry()

    if os.environ.get("SMTPU_ELASTIC", "0") not in ("", "0"):
        return elastic_main(rec, reg, rank, steps, step_s, fleet_dir,
                            _device(argv))

    tr = obs.get_tracer()
    if tr is not None:
        # one pricing per compiled program: sparse wins, the losing
        # candidates' modeled byte costs ride along as the record's "why"
        tr.on_decision("xla", "sparse",
                       {"dense": 8192.0, "sparse": 2048.0,
                        "sparse_q": 1152.0, "bitmap": 1536.0},
                       rows=32, capacity=128, row_bytes=64,
                       quant="int8")

    det = None
    spike_at = spike_rank = -1
    if os.environ.get("SMTPU_FLEET_NUMERICS", "0") not in ("", "0"):
        from swiftmpi_tpu_torch.obs import numerics as obs_numerics
        det = obs_numerics.AnomalyDetector()
        spike_at = int(os.environ.get("SMTPU_FLEET_NUMERICS_SPIKE",
                                      "-1"))
        spike_rank = int(os.environ.get(
            "SMTPU_FLEET_NUMERICS_SPIKE_RANK", "0"))

    for step in range(steps):
        faults.step_event(step)         # hang/kill drills fire here
        with obs.span("dispatch"):
            time.sleep(step_s)
        reg.counter("transfer/wire_bytes",
                    backend="xla").inc(1000 * (rank + 1))
        reg.counter("transfer/dispatches", backend="xla").inc(1)
        reg.counter("transfer/window_fmt", backend="xla",
                    fmt="sparse").inc(1)
        if tr is not None:
            # one synthetic window a step, rank-skewed like the wire
            # counter above (rows x row_bytes = 1000 * (rank + 1))
            tr.stage_keys("xla", [(rank + 1) * k for k in range(8)])
            tr.on_window("xla", "sparse", rows_in=48, rows_out=32)
            tr.on_exchange("xla", rows=250 * (rank + 1), row_bytes=4)
            if rank == 0 and step == steps // 2 and fleet_dir:
                # the operator flow: drop the fleet-wide dump trigger;
                # every rank replays it exactly once
                from swiftmpi_tpu_torch.obs import trace as trace_mod
                trace_mod.request_trace(fleet_dir)
        if det is not None:
            # deterministic per-rank norms (mild skew, below the
            # cross-rank divergence factor) + optional injected spike
            g = 1.0 + 0.1 * rank
            if step == spike_at and rank == spike_rank:
                g *= 40.0
            loss = 2.0 / (1.0 + 0.05 * step)
            reg.gauge("numerics/grad_norm").set(g)
            reg.gauge("numerics/loss").set(loss)
            det.on_sample(reg, {"numerics/grad_norm": g,
                                "numerics/loss": loss}, 0.0)
        obs.record_step(1)

    if tr is not None and fleet_dir:
        # grace window: the trigger poll is throttled, so a trigger
        # dropped near the end of a short drill may not have been seen
        # yet: keep polling (no step advance) until the dump lands
        deadline = time.time() + 3.0
        while not tr.dumps and time.time() < deadline:
            tr.on_step(0)
            time.sleep(0.1)
        # clean teardown: detach WITHOUT dumping
        obs.uninstall_tracer()

    rec.close()
    print(f"FLEET_CHILD_OK rank={rank} steps={steps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
