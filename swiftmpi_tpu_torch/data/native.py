"""ctypes binding to the repository's native C++ data loader
(``native/loader.cpp``, ``native/io.cpp``; counterpart of
``swiftmpi_tpu/data/native.py``).

The host input path in C++: vocab build, corpus mapping, CBOW and stencil
batch assembly (with the prefetching executor), the libSVM parser and the
text row dump/load.  The C++ RNG and seeds are the JAX package's, so a
batcher here yields the same batches, array for array, as the JAX
package's ``NativeCBOWBatcher`` on the same corpus and seed.

The library is compiled from the sources as they stand with ``g++`` into
``build/native/<digest>/libsmtpu_loader.so`` at the repository root
(git-ignored), keyed by a hash of the sources and flags the way
``kernels/build.py`` keys the CUDA kernels, and written through an atomic
rename, so processes building at once never load a partial file.  The
tracked ``native/libsmtpu_loader.so``, which the JAX package rebuilds in
place, is never written or loaded here.  Nothing is built at import:
the first call that needs the library builds it; ``available()`` says
whether that worked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from swiftmpi_tpu_torch.data.text import CBOWBatch, StencilBatch, Vocab
from swiftmpi_tpu_torch.ops.sampling import subsample_keep_prob
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
SOURCES = ("loader.cpp", "io.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-Wall", "-shared", "-fPIC"]
#: where the library is built; the tests point it at a temporary directory
BUILD_ROOT = ROOT / "build" / "native"

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}
_failed: Dict[Path, str] = {}


def digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return Path(BUILD_ROOT) / digest() / "libsmtpu_loader.so"


def build() -> Path:
    """Compile the library unless this digest is built; returns its path.
    Raises ``RuntimeError`` with the compiler's output when g++ fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".libsmtpu_loader.{os.getpid()}."
                         f"{threading.get_ident()}.so")
    cmd = ["g++", *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES),
           "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native loader build failed: {e!r}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed (rc {r.returncode})"
                           f":\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)          # atomic: readers never see a partial
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    p, i64, u64, cint = c.c_void_p, c.c_int64, c.c_uint64, c.c_int
    sigs = {
        "smtpu_vocab_build": (p, [c.c_char_p, cint, i64, i64, i64]),
        "smtpu_vocab_size": (i64, [p]),
        "smtpu_vocab_copy": (None, [p, p, p]),
        "smtpu_vocab_free": (None, [p]),
        "smtpu_corpus_map": (p, [c.c_char_p, cint, p, i64, i64]),
        "smtpu_corpus_n_sentences": (i64, [p]),
        "smtpu_corpus_n_tokens": (i64, [p]),
        "smtpu_corpus_copy": (None, [p, p, p]),
        "smtpu_corpus_free": (None, [p]),
        "smtpu_batcher_new": (p, [p, p, i64, cint, p, u64]),
        "smtpu_batcher_reset": (None, [p, u64]),
        "smtpu_batcher_next": (i64, [p, i64, p, p, p]),
        "smtpu_batcher_next_stencil": (i64, [p, i64, p, p, p, p]),
        "smtpu_batcher_free": (None, [p]),
        "smtpu_prefetcher_new": (p, [p, i64, i64, u64]),
        "smtpu_prefetcher_next": (i64, [p, p, p, p]),
        "smtpu_prefetcher_free": (None, [p]),
        "smtpu_libsvm_parse": (p, [c.c_char_p]),
        "smtpu_libsvm_n_rows": (i64, [p]),
        "smtpu_libsvm_nnz": (i64, [p]),
        "smtpu_libsvm_n_bad": (i64, [p]),
        "smtpu_libsvm_copy": (None, [p] * 5),
        "smtpu_libsvm_free": (None, [p]),
        "smtpu_dump_rows": (i64, [c.c_char_p, p, i64, i64, p, p]),
        "smtpu_load_rows": (p, [c.c_char_p, i64, p]),
        "smtpu_text_n_rows": (i64, [p]),
        "smtpu_text_copy": (None, [p, p, p]),
        "smtpu_text_free": (None, [p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library of the current ``BUILD_ROOT`` (built on first
    use), or None when it does not build (logged once)."""
    key = Path(BUILD_ROOT)
    with _lock:
        if key in _libs:
            return _libs[key]
        if key in _failed:
            return None
        try:
            lib = _declare(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError) as e:
            _failed[key] = str(e)
            log.warning("native loader unavailable (%s); use the Python "
                        "pipeline", e)
            return None
        _libs[key] = lib
        return lib


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable: "
                           + _failed.get(Path(BUILD_ROOT), ""))
    return lib


def available() -> bool:
    return _load_lib() is not None


_MODE = {"int": 0, "bkdr": 1}


def load_corpus_native(path: str, mode: str = "int", min_count: int = 1,
                       min_sentence_length: int = 1,
                       max_sentence_length: int = 1000):
    """One C++ pass for the vocab and one for the corpus mapping.
    Returns ``(vocab, tokens, offsets)``: ``tokens`` int32 vocab indices,
    flattened; ``offsets`` int64 sentence boundaries.  The vocab is
    ordered as :func:`~swiftmpi_tpu_torch.data.text.build_vocab` orders
    it: count descending, then key ascending."""
    lib = _lib_or_raise()
    vp = lib.smtpu_vocab_build(path.encode(), _MODE[mode], min_count,
                               min_sentence_length, max_sentence_length)
    if not vp:
        raise FileNotFoundError(path)
    try:
        V = lib.smtpu_vocab_size(vp)
        keys = np.empty(V, np.uint64)
        counts = np.empty(V, np.int64)
        lib.smtpu_vocab_copy(vp, keys.ctypes.data, counts.ctypes.data)
        vocab = Vocab(keys, counts)
        cp = lib.smtpu_corpus_map(path.encode(), _MODE[mode], vp,
                                  min_sentence_length, max_sentence_length)
        if not cp:
            raise FileNotFoundError(path)
        try:
            n_sent = lib.smtpu_corpus_n_sentences(cp)
            n_tok = lib.smtpu_corpus_n_tokens(cp)
            tokens = np.empty(n_tok, np.int32)
            offsets = np.empty(n_sent + 1, np.int64)
            lib.smtpu_corpus_copy(cp, tokens.ctypes.data,
                                  offsets.ctypes.data)
        finally:
            lib.smtpu_corpus_free(cp)
    finally:
        lib.smtpu_vocab_free(vp)
    return vocab, tokens, offsets


class NativeCBOWBatcher:
    """C++-backed drop-in for ``CBOWBatcher`` (the same batch contract;
    the JAX package's ``NativeCBOWBatcher`` batches, array for array)."""

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray, vocab: Vocab,
                 window: int, sample: float = -1.0, seed: int = 2008):
        lib = _lib_or_raise()
        self._lib = lib
        self.window = int(window)
        self.vocab = vocab
        # the batcher borrows these arrays: keep them alive with it
        self._tokens = np.ascontiguousarray(tokens, np.int32)
        self._offsets = np.ascontiguousarray(offsets, np.int64)
        if sample >= 0:
            self._keep = np.ascontiguousarray(
                subsample_keep_prob(vocab.counts, sample), np.float32)
            keep_ptr = self._keep.ctypes.data
        else:
            self._keep = None
            keep_ptr = None
        self._seed = seed
        self._epoch_i = 0
        self._h = lib.smtpu_batcher_new(
            self._tokens.ctypes.data, self._offsets.ctypes.data,
            len(self._offsets) - 1, self.window, keep_ptr, seed)

    def _drain(self, batch_size: int, next_fn) -> Iterator[CBOWBatch]:
        """The batch-yield loop: ``next_fn(centers, contexts, mask)``
        fills one batch and returns its example count (0: epoch done)."""
        W2 = 2 * self.window
        while True:
            centers = np.zeros(batch_size, np.int32)
            contexts = np.zeros((batch_size, W2), np.int32)
            mask = np.zeros((batch_size, W2), np.uint8)
            n = next_fn(centers.ctypes.data, contexts.ctypes.data,
                        mask.ctypes.data)
            if n == 0:
                return
            yield CBOWBatch(centers, contexts, mask.astype(bool), int(n))
            if n < batch_size:
                return

    def epoch(self, batch_size: int) -> Iterator[CBOWBatch]:
        lib = self._lib
        self._epoch_i += 1
        lib.smtpu_batcher_reset(self._h, self._seed + self._epoch_i)
        yield from self._drain(
            batch_size,
            lambda c, x, m: lib.smtpu_batcher_next(
                self._h, batch_size, c, x, m))

    def epoch_stencil(self, batch_size: int) -> Iterator[StencilBatch]:
        """Stream-span epoch (the wire format of
        ``CBOWBatcher.epoch_stencil``): spans of ``batch_size + 2W``
        tokens with per-center positions, assembled in C++."""
        lib = self._lib
        S = batch_size + 2 * self.window
        self._epoch_i += 1
        lib.smtpu_batcher_reset(self._h, self._seed + self._epoch_i)
        while True:
            tokens = np.zeros(S, np.int32)
            sids = np.zeros(S, np.int32)
            cpos = np.zeros(batch_size, np.int32)
            half = np.zeros(batch_size, np.int32)
            n = lib.smtpu_batcher_next_stencil(
                self._h, batch_size, tokens.ctypes.data, sids.ctypes.data,
                cpos.ctypes.data, half.ctypes.data)
            if n == 0:
                return
            yield StencilBatch(tokens, sids, cpos, half, int(n))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.smtpu_batcher_free(h)


class PrefetchingCBOWBatcher(NativeCBOWBatcher):
    """``NativeCBOWBatcher`` whose epochs run ahead of the consumer: the
    C++ prefetch executor assembles ``epoch`` batches on its own thread
    into a bounded queue (``loader.cpp``); ``epoch_stencil`` gets the same
    overlap from ``io/pipeline.py``'s ``PrefetchIterator`` over the
    synchronous native iterator.  Batches and their order are
    unchanged."""

    def __init__(self, *args, depth: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.depth = int(depth)

    def epoch(self, batch_size: int) -> Iterator[CBOWBatch]:
        lib = self._lib
        self._epoch_i += 1
        p = lib.smtpu_prefetcher_new(self._h, batch_size, self.depth,
                                     self._seed + self._epoch_i)
        try:
            yield from self._drain(
                batch_size,
                lambda c, x, m: lib.smtpu_prefetcher_next(p, c, x, m))
        finally:
            lib.smtpu_prefetcher_free(p)

    def epoch_stencil(self, batch_size: int) -> Iterator[StencilBatch]:
        from swiftmpi_tpu_torch.io.pipeline import PrefetchIterator
        return PrefetchIterator(super().epoch_stencil(batch_size),
                                depth=self.depth,
                                name="native-stencil-prefetch")


# ---- libSVM (io.cpp) ------------------------------------------------------

def parse_libsvm_native(path: str):
    """Whole-file CSR parse: ``(labels (N,), offsets (N+1,), feat_ids
    (nnz,), feat_vals (nnz,))``, labels mapped to {0, 1}."""
    lib = _lib_or_raise()
    h = lib.smtpu_libsvm_parse(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        n_bad = lib.smtpu_libsvm_n_bad(h)
        if n_bad:
            raise ValueError(
                f"{path}: {n_bad} malformed libSVM line(s) "
                "(bad label or feature token)")
        n = lib.smtpu_libsvm_n_rows(h)
        nnz = lib.smtpu_libsvm_nnz(h)
        labels = np.empty(n, np.float32)
        offsets = np.empty(n + 1, np.int64)
        ids = np.empty(nnz, np.uint64)
        vals = np.empty(nnz, np.float32)
        lib.smtpu_libsvm_copy(h, labels.ctypes.data, offsets.ctypes.data,
                              ids.ctypes.data, vals.ctypes.data)
    finally:
        lib.smtpu_libsvm_free(h)
    return labels, offsets, ids, vals


# ---- text rows (io.cpp) ---------------------------------------------------

def dump_rows_native(path: str, keys: np.ndarray, fields) -> int:
    """Write ``key\\tfield0\\tfield1...`` lines; ``fields`` is an ordered
    list of ``(n, d)`` float32 arrays.  Returns the rows written."""
    lib = _lib_or_raise()
    keys = np.ascontiguousarray(keys, np.uint64)
    if len(keys) == 0:            # empty table: an empty file
        open(path, "w").close()
        return 0
    arrs = [np.ascontiguousarray(a, np.float32).reshape(len(keys), -1)
            for a in fields]
    dims = np.asarray([a.shape[1] for a in arrs], np.int64)
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    n = lib.smtpu_dump_rows(path.encode(), keys.ctypes.data, len(keys),
                            len(arrs), ptrs, dims.ctypes.data)
    if n < 0:
        raise OSError(f"cannot write {path}")
    return int(n)


def load_rows_native(path: str, dims):
    """Read ``key\\tfield...`` lines where field j has ``dims[j]`` floats.
    Returns ``(keys (N,), [(N, dims[j]) float32 arrays])``."""
    lib = _lib_or_raise()
    dims = np.asarray(dims, np.int64)
    h = lib.smtpu_load_rows(path.encode(), len(dims), dims.ctypes.data)
    if not h:
        raise FileNotFoundError(path)
    try:
        n = lib.smtpu_text_n_rows(h)
        keys = np.empty(n, np.uint64)
        arrs = [np.empty((n, int(d)), np.float32) for d in dims]
        ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
        lib.smtpu_text_copy(h, keys.ctypes.data, ptrs)
    finally:
        lib.smtpu_text_free(h)
    return keys, arrs
