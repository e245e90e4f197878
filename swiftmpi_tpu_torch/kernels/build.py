"""Build and load the port's CUDA C++ kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds.  The
libraries go into ``build/torch_kernels/<digest>/`` at the repository
root (git-ignored), keyed by a hash of the sources and flags, so a fresh
checkout builds them at first use and a changed source rebuilds.  All
sources compile in parallel, one ``nvcc`` each, started together.

Nothing here runs when a module is imported: the first kernel launch on a
CUDA tensor builds the libraries.  CPU tensors never reach this module
(each wrapper runs its plain version for them), and :func:`build_all`
refuses to run without a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: library name -> CUDA source under csrc/
SOURCES: Dict[str, str] = {
    "gather": "gather.cu",
    "scatter": "scatter.cu",
    "adagrad": "adagrad.cu",
    "stencil": "stencil.cu",
    "ring": "ring.cu",
}

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}

#: per-library compiler output of the last build (ptxas register/smem use)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH)")
    return found


def digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        h.update(name.encode())
        h.update((CSRC / SOURCES[name]).read_bytes())
    return h.hexdigest()[:16]


def library_dir() -> Path:
    return BUILD_ROOT / digest()


def build_all() -> Dict[str, Path]:
    """Compile every library that is not built yet, all in parallel;
    returns name -> path.  Raises when there is no CUDA device or when a
    compile fails (with the compiler's output)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels are built only where a CUDA "
                           "device is available")
    out_dir = library_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"libsmtpu_{name}.so" for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f".libsmtpu_{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate(timeout=600)
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]} "
                          f"(rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[name])   # atomic: readers never see a partial
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name`` (building all libraries on first
    use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            lib = _libs[name] = ctypes.CDLL(str(paths[name]))
        return lib


def function(lib_name: str, symbol: str, argtypes: Sequence):
    """A C entry point with its argument types declared: pointers and the
    stream as ``c_void_p`` (a bare Python int would be cut to 32 bits),
    returning the ``cudaError_t`` of its launch as an int."""
    key = f"{lib_name}:{symbol}"
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
