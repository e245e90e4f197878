"""Single-host multi-process launcher: the ``mpirun -np N`` equivalent
(counterpart of ``swiftmpi_tpu/launch.py``'s ``launch`` and ``main``).

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

* ``-np N``   — number of processes (default 1).
* ``-port P`` — the store's port (default: an OS-assigned free port).

Children's output comes through with a ``[rank k]`` line prefix.  The
first non-zero exit terminates the rest (mpirun semantics): survivors get
SIGTERM, then SIGKILL after a grace period, every child is reaped, and
the readers are drained before :func:`launch` returns, so no child is
left behind.  The first failure's exit code is the launcher's; signal
deaths map to the shell convention ``128 + signum``.

Not ported: the supervisor (``-max-restarts``, ``-elastic``, ``-serve``,
``-fleet-dir``, ``-profile-at``; :func:`supervise`,
:func:`supervise_elastic`, :func:`supervise_serve`), ROADMAP A13b.  The
JAX launcher's ``-cpu D`` gives each child D virtual XLA devices, which
has no torch meaning: it is refused.
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
                                                  ENV_NUM_PROCESSES,
                                                  ENV_PROCESS_ID)

#: flags of the JAX launcher's supervisor, not ported yet
SUPERVISOR_FLAGS = ("max-restarts", "backoff", "stable-after", "elastic",
                    "shards", "join-timeout", "dead-after", "serve",
                    "ship-dir", "trainer-restarts", "fleet-dir",
                    "profile-at", "profile-steps")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(base: Dict[str, str], port: int, rank: int,
               nprocs: int) -> Dict[str, str]:
    env = dict(base)
    env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
    env[ENV_NUM_PROCESSES] = str(nprocs)
    # besides the process-group rank, the identity every log line and
    # telemetry record carries ("r<rank>", obs/identity.py)
    env[ENV_PROCESS_ID] = str(rank)
    return env


def _normalize_rc(code: int) -> int:
    """Child exit code -> process exit code.  Popen reports signal
    deaths as negative numbers; map them to the shell convention 128 +
    signum (SIGKILL -> 137)."""
    return 128 - code if code < 0 else code


def launch(argv: List[str], nprocs: int, port: int = 0,
           kill_grace_s: float = 5.0) -> int:
    """Spawn ``nprocs`` copies of ``argv`` under one store; returns the
    first non-zero child exit code (terminating the others), else 0.

    One reader thread per child (a blocking ``readline`` there cannot
    stall exit detection here); the main thread only polls exit codes.
    SIGTERM on the first failure escalates to SIGKILL after
    ``kill_grace_s``.  Teardown order is kill -> reap -> drain -> join:
    every child is waited for (no zombies), and a reader blocked on a pipe
    a grandchild still holds is unblocked by closing the pipe."""
    port = port or _free_port()
    procs: List[subprocess.Popen] = []
    print_lock = threading.Lock()

    def reader(rank: int, stream) -> None:
        try:
            for line in stream:
                with print_lock:
                    sys.stdout.write(f"[rank {rank}] {line}")
                    sys.stdout.flush()
        except (ValueError, OSError):
            pass     # stream closed by the teardown while blocked

    threads = []
    rc = 0
    try:
        for rank in range(nprocs):
            p = subprocess.Popen(
                argv, env=_child_env(os.environ, port, rank, nprocs),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append(p)
            t = threading.Thread(target=reader, args=(rank, p.stdout),
                                 daemon=True)
            t.start()
            threads.append(t)
        while any(p.poll() is None for p in procs):
            time.sleep(0.1)
            for p in procs:
                code = p.poll()
                if code not in (None, 0) and rc == 0:
                    rc = _normalize_rc(code)       # the first failure wins
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
                    deadline = time.monotonic() + kill_grace_s
                    for q in procs:
                        try:
                            q.wait(max(0.0, deadline - time.monotonic()))
                        except subprocess.TimeoutExpired:
                            q.kill()               # SIGTERM ignored
        for p in procs:
            code = p.wait()
            if code and rc == 0:
                rc = _normalize_rc(code)
    finally:
        # kill: nothing may survive this function, success or raise
        for p in procs:
            if p.poll() is None:
                p.kill()
        # reap: every kill needs a wait or the child stays a zombie
        for p in procs:
            try:
                p.wait(timeout=kill_grace_s)
            except subprocess.TimeoutExpired:
                pass               # unkillable (D-state); nothing to do
        # drain: a child's death ends its pipe, unless a grandchild holds
        # it open; then close the read end to unblock the reader
        for t in threads:
            t.join(timeout=2.0)
        for p, t in zip(procs, threads):
            if t.is_alive():
                try:
                    p.stdout.close()
                except (ValueError, OSError):
                    pass
        for t in threads:
            t.join(timeout=1.0)
    return rc


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} (the supervised launcher: restarts, elastic membership, "
        "serve fleets, the fleet directory, pre-armed profiler windows) is "
        "not ported yet (ROADMAP A13b)")


def supervise(*args, **kwargs) -> int:
    _not_ported("supervise")


def supervise_elastic(*args, **kwargs) -> int:
    _not_ported("supervise_elastic")


def supervise_serve(*args, **kwargs) -> int:
    _not_ported("supervise_serve")


def main(args: Optional[List[str]] = None) -> int:
    from swiftmpi_tpu_torch.utils.cmdline import CMDLine

    if args is None:
        args = sys.argv[1:]
    if "--" not in args:
        print("usage: python -m swiftmpi_tpu_torch.launch -np N [-port P] "
              "-- prog args...", file=sys.stderr)
        return 2
    split = args.index("--")
    cmd = CMDLine(["launch"] + args[:split])
    cmd.registerParameter("np", "number of processes")
    cmd.registerParameter("port", "the store's port")
    prog = args[split + 1:]
    if not prog:
        print("launch: nothing to run after --", file=sys.stderr)
        return 2
    if cmd.hasParameter("cpu"):
        print("launch: -cpu sets up virtual XLA devices, which has no torch "
              "meaning; pass -device cpu to the program instead",
              file=sys.stderr)
        return 2
    for flag in SUPERVISOR_FLAGS:
        if cmd.hasParameter(flag):
            _not_ported(f"-{flag}")
    nprocs = int(cmd.get_value("np")) if cmd.hasParameter("np") else 1
    port = int(cmd.get_value("port")) if cmd.hasParameter("port") else 0
    return launch(prog, nprocs, port=port)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
