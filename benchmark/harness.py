"""One run of a cell, whatever its model: set-up, the checked steps, the
measured window, the traced run's per-layer context, and the output
check.  What is the model's (building it, its checked steps, its window
call, its counters, its reference) sits in ``models/<model>.py``, found
by the configuration's ``model`` key (``models/__init__.py`` lists what
such a module has)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import torch

from benchmark import spec
from benchmark.reference import check

#: top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "swiftmpi_tpu")
_T_IMPORT = time.perf_counter()


def seconds_since_process_start() -> float:
    """Uptime minus this process's start time (``/proc``); where that
    cannot be read, the seconds since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot), whole,
    is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN})


class Parts:
    """The set-up's parts in seconds, each ended by a synchronize."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds = {"before_run_s": seconds_since_process_start()}

    def __call__(self, name: str):
        parts = self

        class _Part:
            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                if parts.dev.type == "cuda":
                    torch.cuda.synchronize(parts.dev)
                parts.seconds[name] = time.perf_counter() - self.t
        return _Part()


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", cell: Optional[spec.Cell] = None,
             log=print) -> dict:
    """One run; returns the result line's object (``check`` last)."""
    cell = cell or spec.load_cell(name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    parts = Parts(dev)
    prog = spec.model_module(cell).Program(cell, seed, dev, parts)
    prog.checked_steps()
    ctx = {"peaks": _card_peaks(dev)}
    prof = prog.profile() if traced else None
    setup_s = seconds_since_process_start()
    log(json.dumps({"setup": {**parts.seconds, "setup_s": setup_s}}))

    out = prog.window(seconds)
    if traced:
        ctx.update(out["ctx"])
        prog.count(ctx)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    prog.release()

    nums = prog.numbers()
    if traced:
        ctx.update(prog.trace_context(prof))

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"forbidden modules loaded: {bad}")
    result = {
        "correct": check.judge(nums, cell.limits),
        "attempted": out["attempted"], "failed": 0, "metrics": {},
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if not traced:
        values = {**out["values"], "peak_device_gib": memory_peak / 2**30,
                  "setup_s": setup_s}
        for e in cell.end_to_end:
            result["metrics"][e["name"]] = {"value": values[e["name"]],
                                            "unit": e["unit"]}
    else:
        for p in cell.per_layer:
            v = spec.metric_reader(p["name"])(ctx)
            if v is not None:
                result["metrics"][p["name"]] = {"value": v,
                                                "unit": p["unit"]}
        w = ctx.get("window")
        if w is not None:
            result["device"]["busy_s"] = w.busy_s
            result["device"]["window_s"] = w.window_s
            result["breakdown"] = {"device_ops": w.top_ops(),
                                   "idle_gaps": w.idle_gaps()}
    result["info"] = {k: v for k, v in nums.items() if k not in cell.limits}
    result["check"] = {k: {"value": nums.get(k), "limit": lim}
                       for k, lim in cell.limits.items()}
    return result


def emit(result: dict, out=None, err=None) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error, then the result line, last on standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    print(json.dumps(result), file=out, flush=True)


def _card_peaks(dev) -> Optional[dict]:
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for key, row in spec.peaks().items():
        if isinstance(row, dict) and key in name:
            return row
    return None
