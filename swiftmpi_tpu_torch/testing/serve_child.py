"""Serve-fleet worker: one rank of a ``launch.py -serve N`` world
(counterpart of the JAX package's ``scripts/_serve_child.py``, whose
environment knobs and output lines it keeps).

    python -m swiftmpi_tpu_torch.launch -serve 2 -fleet-dir D -- \\
        python -m swiftmpi_tpu_torch.testing.serve_child [-device cpu]

The role comes from ``SMTPU_SERVE_ROLE`` (the serve supervisor sets it:
rank 0 = ``trainer``, ranks 1..N = ``replica``); the snapshot stream
lives in ``SMTPU_SHIP_DIR``.  Nothing here is cross-process beyond the
ship directory: no process group, no collectives.

**Trainer**: a synthetic hot-head table (``SMTPU_SERVE_VOCAB`` rows x
``SMTPU_SERVE_DIM``, ``SMTPU_SERVE_NHOT`` hot) whose planes are tensors on
the card (``-device cpu`` puts them on the CPU), trained with a Zipf
touched-row set a step (``SMTPU_SERVE_ZIPF``, low slots hottest).  The
draws are numpy's, from the JAX child's seeds, and each step adds its
update onto the touched rows, which are distinct, with ``index_add_``: one
addition an element, so the planes equal the JAX child's numpy planes
bit for bit.  Every ``SMTPU_SERVE_EVERY`` steps it publishes through the
port's :class:`~swiftmpi_tpu_torch.serve.snapshot.SnapshotPublisher` (one
device-to-host copy of the planes) and ships the snapshot with
:class:`~swiftmpi_tpu_torch.serve.shipper.SnapshotShipper`: a full base
first, priced deltas after, booking ``serve/delta_*`` telemetry.  The
fault bus fires at the top of every step (``SMTPU_FAULT_PLAN`` kill
drills); a restarted trainer's shipper resumes the version chain past the
manifest tail.

**Replica**: stays on the host (the serving readers never touch the
device).  It replays the stream with
:class:`~swiftmpi_tpu_torch.serve.shipper.SnapshotReplica` (blocking on
``wait_for_version(1)`` for the base, the cross-process staleness bound),
then runs an open-loop Zipf query storm through
:class:`~swiftmpi_tpu_torch.serve.reader.EmbeddingReader`
(``SMTPU_SERVE_QPS`` paced queries a second of ``SMTPU_SERVE_QSIZE``-key
batches), polling for new versions each step.  A dead trainer does not
stop the storm: the replica keeps serving the last applied version.
Unlike the JAX child, a replica serves past its step budget until it has
applied the trainer's last ship (version ``SMTPU_SERVE_STEPS //
SMTPU_SERVE_EVERY``, the trainer sharing both knobs), for at most
``SMTPU_SERVE_SYNC_TIMEOUT_S``: a drill then ends on the evidence (the
tail replayed), not on how fast a restarted replica started.

Prints ``SERVE_CHILD_OK role=<role> rank=<r> version=<v> ...`` on a clean
finish (the trainer adds ``device=<d>``; a replica adds its first sync's
seconds and the bytes it replayed then: ``resync_s``, ``base_bytes``
(the full base's payload on disk), ``delta_bytes`` and ``deltas``); a
replica that never sees a base exits rc 4.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.utils.config import ConfigParser


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


def _zipf_slots(rng, n: int, vocab: int, alpha: float) -> np.ndarray:
    """Zipf-shaped slot draws with slot 0 hottest (the hot head is the
    low slots, the layout the shipper prices)."""
    z = rng.zipf(alpha, size=n)
    return np.minimum(z - 1, vocab - 1).astype(np.int64)


class _Table:
    """A SnapshotPublisher-capturable table: a state dict of device
    planes and the key index's ``n_hot``."""

    def __init__(self, vocab: int, dim: int, n_hot: int, seed: int,
                 device):
        import torch
        rng = np.random.default_rng(seed)
        host = {
            "v@hot": rng.normal(size=(n_hot, dim)).astype(np.float32),
            "v": rng.normal(size=(vocab - n_hot, dim)).astype(np.float32),
        }
        self.state = {f: torch.from_numpy(v).to(device)
                      for f, v in host.items()}
        self.n_hot = n_hot

        class _KI:
            n_hot = self.n_hot
        self.key_index = _KI()

    def apply(self, rows: np.ndarray, upd: np.ndarray) -> None:
        """Add ``upd`` onto the distinct ``rows`` (unified slots): the hot
        ones into ``v@hot``, the tail ones into ``v``."""
        import torch
        hot = rows[rows < self.n_hot]
        tail = rows[rows >= self.n_hot] - self.n_hot
        for f, idx, part in (("v@hot", hot, upd[:len(hot)]),
                             ("v", tail, upd[len(rows) - len(tail):])):
            plane = self.state[f]
            plane.index_add_(0, torch.from_numpy(idx).to(plane.device),
                             torch.from_numpy(part).to(plane.device))


def trainer_main(rec, reg, rank: int, steps: int, step_s: float,
                 ship_dir: str, device=None) -> int:
    from swiftmpi_tpu_torch.device import resolve_device
    from swiftmpi_tpu_torch.serve.shipper import SnapshotShipper
    from swiftmpi_tpu_torch.serve.snapshot import SnapshotPublisher

    vocab = _env_int("SMTPU_SERVE_VOCAB", 4096)
    dim = _env_int("SMTPU_SERVE_DIM", 16)
    n_hot = _env_int("SMTPU_SERVE_NHOT", 256)
    every = _env_int("SMTPU_SERVE_EVERY", 5)
    touch = _env_int("SMTPU_SERVE_TOUCH", 128)
    alpha = _env_float("SMTPU_SERVE_ZIPF", 1.3)
    quant = os.environ.get("SMTPU_SERVE_QUANT", "int8")

    dev = resolve_device(device)
    tbl = _Table(vocab, dim, n_hot, seed=7, device=dev)
    keys = np.arange(1, vocab + 1, dtype=np.uint64)
    slots = np.arange(vocab, dtype=np.int64)
    pub = SnapshotPublisher(every=1)
    shipper = SnapshotShipper(ship_dir, quant=quant)
    rng = np.random.default_rng(1000 + shipper.version)
    touched_keys: set = set()
    for step in range(steps):
        faults.step_event(step)       # kill drills fire here
        with obs.span("dispatch"):
            hit = _zipf_slots(rng, touch, vocab, alpha)
            rows = np.unique(hit)
            upd = rng.normal(scale=0.05,
                             size=(len(rows), dim)).astype(np.float32)
            tbl.apply(rows, upd)
            touched_keys.update((rows + 1).tolist())
            time.sleep(step_s)
        if (step + 1) % every == 0:
            snap = pub.publish(tbl, keys=keys, slots=slots,
                               meta={"query_field": "v"})
            recd = shipper.ship(
                snap, touched=np.fromiter(touched_keys, np.uint64,
                                          len(touched_keys)))
            touched_keys.clear()
            print(f"SERVE_SHIP v{recd['version']} kind={recd['kind']} "
                  f"bytes={recd['bytes']} full={recd['full_bytes']} "
                  f"fmt={recd['fmt']}", flush=True)
        obs.record_step(1)
    rec.close()
    print(f"SERVE_CHILD_OK role=trainer rank={rank} "
          f"version={shipper.version} steps={steps} device={dev.type}")
    return 0


def _replayed_bytes(ship_dir: str, version: int) -> tuple:
    """The payload bytes on disk a replica applied to reach ``version``:
    the newest full base at or below it and the deltas after that base
    (``SnapshotReplica``'s replay), as (base, deltas, number of deltas)."""
    from swiftmpi_tpu_torch.serve.shipper import _payload_path, read_manifest
    chain = [r for r in read_manifest(ship_dir) if r["version"] <= version]
    base = max((i for i, r in enumerate(chain) if r["kind"] == "full"),
               default=None)
    if base is None:
        return 0, 0, 0
    size = [os.path.getsize(_payload_path(ship_dir, r["version"]))
            for r in chain[base:]]
    return size[0], sum(size[1:]), len(size) - 1


def replica_main(rec, reg, rank: int, steps: int, step_s: float,
                 ship_dir: str) -> int:
    from swiftmpi_tpu_torch.serve.reader import EmbeddingReader
    from swiftmpi_tpu_torch.serve.shipper import SnapshotReplica

    vocab = _env_int("SMTPU_SERVE_VOCAB", 4096)
    alpha = _env_float("SMTPU_SERVE_ZIPF", 1.3)
    qsize = _env_int("SMTPU_SERVE_QSIZE", 32)
    rate = _env_float("SMTPU_SERVE_QPS", 200.0)
    sync_s = _env_float("SMTPU_SERVE_SYNC_TIMEOUT_S", 30.0)
    # the trainer's last ship: one every SMTPU_SERVE_EVERY of its steps
    until = steps // _env_int("SMTPU_SERVE_EVERY", 5)

    replica = SnapshotReplica(ship_dir)
    t0 = time.perf_counter()
    # cross-process bounded staleness: refuse to serve before the first
    # shipped base lands
    if replica.wait_for_version(1, timeout=sync_s) is None:
        print(f"serve_child: rank {rank} saw no base within {sync_s}s",
              file=sys.stderr)
        return 4
    resync_s = time.perf_counter() - t0
    base_bytes, delta_bytes, deltas = _replayed_bytes(ship_dir,
                                                      replica.version)
    reader = EmbeddingReader(replica, field="v",
                             cache_rows=_env_int(
                                 "SMTPU_SERVE_CACHE_ROWS", 1024))
    rng = np.random.default_rng(17 + rank)
    gap = 1.0 / rate if rate > 0 else 0.0
    queries = 0
    step, deadline = 0, None
    while step < steps or replica.version < until:
        if step >= steps:
            deadline = deadline or time.monotonic() + sync_s
            if time.monotonic() > deadline:
                break
        faults.step_event(step)       # replica-kill drills fire here
        t_end = time.perf_counter() + step_s
        with obs.span("dispatch"):
            while True:
                t_q = time.perf_counter()
                if t_q >= t_end:
                    break
                replica.poll()
                qkeys = _zipf_slots(rng, qsize, vocab, alpha) + 1
                reader.read(qkeys)
                queries += 1
                # open-loop pacing: hold the offered rate even when a
                # query runs long (sleep only the remaining gap)
                rest = gap - (time.perf_counter() - t_q)
                if rest > 0:
                    time.sleep(min(rest, max(t_end - time.perf_counter(),
                                             0.0)))
        obs.record_step(1)
        step += 1
    lat = reader.latency_quantiles()
    rec.close()
    print(f"SERVE_CHILD_OK role=replica rank={rank} "
          f"version={replica.version} queries={queries} "
          f"p50={lat['p50_ms']:.3f} p99={lat['p99_ms']:.3f} "
          f"hit={reader.hit_ratio():.3f} "
          f"stale_s={replica.staleness_s():.3f} resync_s={resync_s:.3f} "
          f"base_bytes={base_bytes} delta_bytes={delta_bytes} "
          f"deltas={deltas}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("-device") + 1] if "-device" in argv else None
    steps = _env_int("SMTPU_SERVE_STEPS", 40)
    step_s = _env_float("SMTPU_SERVE_STEP_S", 0.05)
    hb_s = _env_float("SMTPU_FLEET_HB_S", 0.25)
    ship_dir = os.environ.get("SMTPU_SHIP_DIR", "")
    if not ship_dir:
        print("serve_child: SMTPU_SHIP_DIR not set (run under "
              "launch.py -serve N)", file=sys.stderr)
        return 2
    cfg = ConfigParser().update({
        "worker": {"telemetry": 1},
        "obs": {"heartbeat_s": hb_s},
    })
    rec = obs.configure(cfg, run="serve_child")
    if rec is None:
        print("serve_child: telemetry failed to arm", file=sys.stderr)
        return 2
    rank = obs.process_rank() or 0
    reg = obs.get_registry()
    role = os.environ.get("SMTPU_SERVE_ROLE",
                          "trainer" if rank == 0 else "replica")
    if role == "trainer":
        return trainer_main(rec, reg, rank, steps, step_s, ship_dir,
                            device)
    return replica_main(rec, reg, rank, steps, step_s, ship_dir)


if __name__ == "__main__":
    sys.exit(main())
