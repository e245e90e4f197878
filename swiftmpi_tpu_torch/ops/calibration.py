"""Measurement-driven route selection: the device-kind verdict store
(counterpart of ``swiftmpi_tpu/ops/calibration.py``).

The sweep apps (``apps/{gather,scatter,ring,stencil}_sweep.py``, the
counterparts of ``scripts/{gather,scatter}_micro.py``) time each
hand-written kernel beside the library call that computes the same
function and record an A/B verdict here; the ``[cluster] data_plane``
knob consults it:

    record("ring_push", "NVIDIA H100 80GB HBM3", {"kernel_ms": ..,
                                                  "library_ms": ..})
    lookup("ring_push", "NVIDIA H100 80GB HBM3")  -> dict | None

A verdict's key is the kernel's name and the device kind
(``torch.cuda.get_device_name``); it carries the stack it was measured
under (:func:`stack_key`: the torch version, the CUDA runtime version and
the digest of the kernel sources ``kernels/build.py`` compiles), and a
verdict from another stack is ignored with a loud message.  A sweep
records one verdict over every shape it measured: the library "wins"
only where it is at least 10% faster at each of them.

The store is a JSON file that the caller names: every function takes its
path as an argument, and :func:`use_store` names the process's default.
**There is no default store**: until a process names one, nothing is
read or recorded, and the sweep apps record only under ``-store PATH``.
Verdicts are measured, never committed.

One deliberate difference from the JAX package: **the default is the
kernel.**  JAX's gates take the library (XLA) route unless a recorded
on-chip win says its Pallas kernel is faster.  The port runs its
hand-written kernel unless the process named a store in which a current
verdict for this device kind and stack records the library route at
least 10% faster than a *correct* kernel (:func:`gated`), and then it
says so in a warning.  ``data_plane: xla`` is the user's explicit choice
of the library route, ``pallas`` of the kernel (:func:`data_plane_gated`).
There are no environment switches.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Dict, Optional

_LOCK = threading.Lock()
_CACHE: Dict[str, dict] = {}
_STACK: Optional[dict] = None
_STALE_WARNED: set = set()
_ROUTES_LOGGED: set = set()

#: the process's default store, None until :func:`use_store` names one
_default_path: Optional[str] = None

#: the hand-written kernels behind a verdict, B1 to B5 (PERF.md §6), by
#: the JAX package's verdict names where it has one;
#: :func:`kernel_status` walks this list
KERNELS = {"adagrad_update": "B1", "vmem_gather": "B2",
           "vmem_scatter": "B3", "stencil_fused": "B4", "ring_push": "B5"}

#: the device kind of a CPU tensor: its wrappers run their plain
#: versions, so it has no verdict
CPU_KIND = "cpu"

#: legal values of the ``[cluster] data_plane:`` knob
DATA_PLANE_MODES = ("auto", "pallas", "xla")

#: a verdict flips a route only for a margin of at least 10%
MARGIN = 0.9


def use_store(path: Optional[str]) -> Optional[str]:
    """Make ``path`` the process's default store (None: no store);
    returns the previous default."""
    global _default_path
    prev = _default_path
    _default_path = None if path is None else str(path)
    return prev


def _path(path: Optional[str]) -> Optional[str]:
    return _default_path if path is None else str(path)


def _named(path: Optional[str]) -> str:
    p = _path(path)
    if p is None:
        raise ValueError("no verdict store named: pass path= or call "
                         "calibration.use_store(PATH)")
    return p


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _load(path: Optional[str] = None) -> dict:
    p = _path(path)
    if p is None:
        return {}
    data = _CACHE.get(p)
    if data is None:
        data = _CACHE[p] = _read(p)
    return data


def stack_key() -> dict:
    """The software stack a verdict was measured under: the torch
    version, the CUDA runtime torch was built for, and the digest of the
    kernel sources and flags ``kernels/build.py`` compiles.  A kernel's
    win or loss can flip with any of them, so the stack is part of a
    verdict's identity like the device kind in its key.  Resolved
    without touching a CUDA device."""
    global _STACK
    if _STACK is None:
        import torch

        from swiftmpi_tpu_torch.kernels import build
        _STACK = {"torch": torch.__version__,
                  "cuda": torch.version.cuda or "none",
                  "kernels": build.digest()}
    return dict(_STACK)


def _stale_reason(verdict: dict) -> Optional[str]:
    """Why a verdict must not steer a route on this stack, or None."""
    got = verdict.get("stack")
    if not isinstance(got, dict):
        return "recorded without a stack stamp"
    cur = stack_key()
    diffs = [f"{k} {got.get(k, '?')} -> {cur[k]}"
             for k in cur if got.get(k) != cur[k]]
    if diffs:
        return "recorded on a different stack: " + ", ".join(diffs)
    return None


def lookup(name: str, kind: str, path: Optional[str] = None
           ) -> Optional[dict]:
    """The verdict for (kernel, device kind), or None.  A verdict
    recorded under another torch/CUDA/kernel-source stack (or with no
    stamp) is ignored with a loud re-calibrate message: a stale A/B
    result must never steer a route."""
    key = f"{name}:{kind}"
    verdict = _load(path).get(key)
    if not isinstance(verdict, dict):
        return None
    reason = _stale_reason(verdict)
    if reason is not None:
        if (key, _path(path)) not in _STALE_WARNED:
            _STALE_WARNED.add((key, _path(path)))
            print(f"calibration: STALE verdict ignored for {key} "
                  f"({reason}) — RE-CALIBRATE via python -m "
                  f"swiftmpi_tpu_torch.apps.{{gather,scatter,ring,stencil}}"
                  f"_sweep on the card", file=sys.stderr, flush=True)
        return None
    return verdict


def stale_keys(path: Optional[str] = None) -> list:
    """``[(key, reason)]`` for every stored verdict this stack must
    reject (the ``--stale-check`` CLI reads it)."""
    out = []
    for key, verdict in sorted(_load(path).items()):
        if not isinstance(verdict, dict):
            continue
        reason = _stale_reason(verdict)
        if reason is not None:
            out.append((key, reason))
    return out


def _write(path: str, data: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def record(name: str, kind: str, verdict: dict,
           path: Optional[str] = None) -> None:
    """Persist a verdict stamped with the current stack (unless it
    carries its own ``stack``), merged into the store under a lock."""
    verdict = dict(verdict)
    verdict.setdefault("stack", stack_key())
    p = _named(path)
    with _LOCK:
        data = _read(p)
        data[f"{name}:{kind}"] = verdict
        _write(p, data)
        _CACHE[p] = data


def clear(name: str, path: Optional[str] = None) -> None:
    """Remove every verdict for ``name`` (all device kinds): the rollback
    when a route that won its sweep breaks the full step."""
    p = _named(path)
    with _LOCK:
        if not os.path.exists(p):
            # the memo must not keep serving a verdict the caller
            # believes was cleared
            _CACHE[p] = {}
            return
        data = _read(p)
        kept = {k: v for k, v in data.items()
                if not k.startswith(name + ":")}
        if kept != data:
            _write(p, kept)
        _CACHE[p] = kept


def reset_cache() -> None:
    """Drop the in-process memo, the stale warnings and the logged
    routes (tests; or after an external write)."""
    _CACHE.clear()
    _STALE_WARNED.clear()
    _ROUTES_LOGGED.clear()


def device_key(device=None) -> str:
    """The store's key for a card: its kind, ``torch.cuda.
    get_device_name`` (a verdict measured on one generation must not
    steer another); :data:`CPU_KIND` for the CPU."""
    import torch
    if device is not None and torch.device(device).type == "cpu":
        return CPU_KIND
    if not torch.cuda.is_available():
        return CPU_KIND
    return torch.cuda.get_device_name(device)


def _listed(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def ab_verdict(name: str, library_ms, kernel_ms=None,
               correct: bool = None, shape=None,
               error: str = None, extra: dict = None,
               path: Optional[str] = None, record_it: bool = True,
               device=None) -> dict:
    """The standard A/B verdict of a sweep over one shape or several
    (``library_ms``, ``kernel_ms`` and ``shape`` then lists, one entry a
    shape), recorded (``record_it``) when it was measured on a card and a
    store is named.  ``win``: a correct kernel at least 10% faster than
    the library call at every shape (JAX's sense); ``library_win``: the
    library call at least 10% faster than a correct kernel at every
    shape, the only verdict that turns ``auto`` to the library route.  A
    failed build or launch (``error``) is a loud non-win that leaves the
    kernel route."""
    lib = _listed(library_ms)
    if error is not None:
        verdict = {"win": False, "library_win": False, "error": error,
                   "library_ms": library_ms}
    else:
        ker = _listed(kernel_ms)
        if len(ker) != len(lib):
            raise ValueError(f"{name}: {len(ker)} kernel times against "
                             f"{len(lib)} library times")
        ok = bool(correct)
        verdict = {"win": ok and all(k < MARGIN * b
                                     for k, b in zip(ker, lib)),
                   "library_win": ok and all(b < MARGIN * k
                                             for k, b in zip(ker, lib)),
                   "correct": ok, "kernel_ms": kernel_ms,
                   "library_ms": library_ms}
        if shape:
            verdict["shape"] = shape
    verdict.update(extra or {})
    kind = device_key(device)
    if record_it and kind != CPU_KIND and _path(path) is not None:
        record(name, kind, verdict, path)
        print(f"calibration recorded: {name}:{kind} -> {verdict}",
              flush=True)
    else:
        print(f"calibration NOT recorded: {name} -> {verdict}", flush=True)
    return verdict


def kernel_status(kind: Optional[str] = None,
                  path: Optional[str] = None) -> str:
    """One line on B1 to B5 for a device kind: ``measured`` once a
    current on-card A/B verdict exists for any of them (with the kernels
    the library beats, if any), else ``unmeasured-on-card`` and whether
    a build failed."""
    if kind is None:
        kind = device_key()
    verdicts = {n: lookup(n, kind, path) for n in KERNELS}
    measured = {n: v for n, v in verdicts.items()
                if v and "kernel_ms" in v and "library_ms" in v}
    if not measured:
        errs = sorted(KERNELS[n] for n, v in verdicts.items()
                      if v and "error" in v)
        if errs:
            return ("unmeasured-on-card (attempted, failed: "
                    + ", ".join(errs) + ")")
        return "unmeasured-on-card"
    lib = sorted(KERNELS[n] for n, v in measured.items()
                 if v.get("library_win"))
    wins = sorted(KERNELS[n] for n, v in measured.items() if v.get("win"))
    out = "measured: kernel wins (" + ", ".join(wins) + ")" if wins \
        else "measured: no kernel win"
    if lib:
        out += "; library wins (" + ", ".join(lib) + ")"
    return out


def gated(name: str, kind: Optional[str] = None,
          path: Optional[str] = None) -> bool:
    """Whether ``auto`` runs the kernel: always, unless a named store
    holds a current verdict for this device kind and stack that the
    library call is at least 10% faster than a correct kernel."""
    if kind is None:
        kind = device_key()
    verdict = lookup(name, kind, path)
    return not (verdict and verdict.get("library_win"))


def data_plane_gated(mode: str, name: str, kind: Optional[str] = None,
                     path: Optional[str] = None) -> bool:
    """Resolve the ``[cluster] data_plane:`` knob for one kernel:
    ``xla`` takes the library route, ``pallas`` the kernel, ``auto``
    :func:`gated`'s verdict policy."""
    if mode not in DATA_PLANE_MODES:
        raise ValueError(
            f"[cluster] data_plane must be one of {DATA_PLANE_MODES}, "
            f"got {mode!r}")
    if mode == "xla":
        return False
    if mode == "pallas":
        return True
    return gated(name, kind, path)


def route(mode: str, name: str, device=None,
          path: Optional[str] = None) -> str:
    """``"kernel"`` or ``"library"`` for ``name`` under ``mode``, logged
    once a process for each (kernel, mode, route); a verdict that turns
    ``auto`` to the library route is logged as a warning, with the
    store it came from.  A CPU device runs the plain versions whatever
    the route, so it reads no verdict."""
    kind = device_key(device)
    if kind == CPU_KIND and mode == "auto":
        use = True
    else:
        use = data_plane_gated(mode, name, kind, path)
    got = "kernel" if use else "library"
    if (name, mode, got) not in _ROUTES_LOGGED:
        _ROUTES_LOGGED.add((name, mode, got))
        from swiftmpi_tpu_torch.utils.logger import get_logger
        log = get_logger(__name__)
        if mode == "auto" and not use:
            log.warning("data_plane auto: %s runs the library route (%s): "
                        "the verdict in %s records the library at least "
                        "10%% faster than the kernel", name, kind,
                        _path(path))
        else:
            log.info("data_plane %s: %s runs the %s route (%s)", mode,
                     name, got, kind)
    return got


def main(argv=None) -> int:
    """``python -m swiftmpi_tpu_torch.ops.calibration --stale-check
    --path P``: an advisory report on the verdicts in the store ``P``
    (or the one :func:`use_store` named) against this stack (exit 0);
    ``--stale-check=strict`` exits 1 on any stale verdict, so a
    deployment can refuse to start on another stack's verdicts."""
    argv = list(sys.argv[1:] if argv is None else argv)
    strict = "--stale-check=strict" in argv
    path = None
    if "--path" in argv:
        i = argv.index("--path")
        if i + 1 >= len(argv):
            print("--path needs a file", file=sys.stderr)
            return 2
        path = argv[i + 1]
    p = _path(path)
    if p is None:
        print("calibration: no verdict store named (--path FILE)")
        return 0
    if not os.path.exists(p):
        print(f"calibration: no verdict file at {p}")
        return 0
    stale = stale_keys(path)
    total = len([v for v in _load(path).values() if isinstance(v, dict)])
    if not stale:
        print(f"calibration: {total} verdict(s) at {p} match the "
              f"current stack {stack_key()}")
        return 0
    label = "GATE" if strict else "ADVISORY"
    print(f"calibration {label}: {len(stale)}/{total} verdict(s) at {p} "
          f"are STALE on this stack {stack_key()} — routes stay on the "
          f"kernels; re-calibrate on the card with python -m "
          f"swiftmpi_tpu_torch.apps.{{gather,scatter,ring,stencil}}_sweep:")
    for key, reason in stale:
        print(f"  {key}: {reason}")
    return 1 if strict else 0


if __name__ == "__main__":
    sys.exit(main())
