"""Checkpoint out / load for sparse tables (counterpart of
``swiftmpi_tpu/io/checkpoint.py``).

Two formats, each the JAX package's to the byte or to the array, so a
file written by either package loads in the other:

* **Text** — ``key\\t<value>`` lines, one per occupied row, the
  reference's checkpoint format (reference sparsetable.h:119-132).  With
  no formatter the value is the given fields' float vectors, space-joined
  and tab-separated, written by the native C++ writer
  (``data/native.py``, io.cpp ``smtpu_dump_rows``, ``%.9g``) when its
  library builds, as the JAX package writes it; ``load_table_text`` reads
  through the native reader or a parser, with the reference's per-server
  ownership filter (``shard_filter``, server.h:49-62), and grows a table
  whose capacity the dump outgrows.
* **Binary (npz)** — full-fidelity mid-training checkpoints: every field
  (the AdaGrad sums included), the key index and extra arrays, under the
  JAX package's names (``field__<f>``, ``keys``, ``slots``,
  ``num_shards``, ``capacity_per_shard``, ``n_hot``, ``extra__<k>``),
  each array with a ``__crc__<name>`` CRC32; written atomically (a
  pid-unique tmp, fsync, rename, directory fsync) with an optional last-k
  generation window.  bfloat16 fields are saved upcast to float32 and cast
  back on load (exact).  A sharded table is saved as its global array; a
  hybrid table's hot planes as ``field__<f>@hot`` beside the tail, with
  ``n_hot`` (a load refuses another ``n_hot``: the partition is fixed at
  vocab build).  ``load_checkpoint`` copies into the table's existing
  tensors, so their addresses do not move (a captured CUDA graph stays
  valid); only a checkpoint of a larger capacity replaces them.

Text dumps and loads index the unified slot space (hot rows first), so a
hybrid table's dump is the same file as any other's.  The side planes
travel as fields under the JAX package's names, at their own dtypes:
``field__<f>@ef`` (float32 error-feedback residuals) and
``field__@rowver`` (int32 row versions).  A load refuses a checkpoint
whose ``@ef`` planes differ from the table's (pending residuals would
vanish, or a resume would start from zero residuals under another
``[cluster] wire_quant``); a table with a ``@rowver`` plane restored from
a checkpoint without one keeps the plane at zero (version 0: never
applied), and a checkpoint's plane arms a table without one.

In a run of several processes every process holds the same replica and
computes each dump and checkpoint; only process 0
(``cluster.bootstrap.is_writer``) writes it, as the JAX package does.
Every process loads.
"""

from __future__ import annotations

import glob
import os
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.cluster.bootstrap import is_writer
from swiftmpi_tpu_torch.parameter.key_index import CapacityError
from swiftmpi_tpu_torch.parameter.sparse_table import (ROWVER_KEY,
                                                       SparseTable, hot_name,
                                                       is_ef_field,
                                                       tensor_to_numpy)
from swiftmpi_tpu_torch.utils.logger import get_logger

log = get_logger(__name__)

Formatter = Callable[[Dict[str, np.ndarray]], str]
Parser = Callable[[str], Dict[str, np.ndarray]]


def default_formatter(fields) -> Formatter:
    """Space-joined values per field, tab between fields, in given order."""
    def fmt(row: Dict[str, np.ndarray]) -> str:
        return "\t".join(
            " ".join(repr(float(x)) for x in np.ravel(row[f]))
            for f in fields)
    return fmt


def default_parser(fields) -> Parser:
    def parse(text: str) -> Dict[str, np.ndarray]:
        parts = text.split("\t")
        return {f: np.array([float(x) for x in p.split()], np.float32)
                for f, p in zip(fields, parts)}
    return parse


# -- text (reference-compatible) ------------------------------------------

def _lookup_growing(table: SparseTable, keys) -> np.ndarray:
    """``key_index.lookup`` that doubles the table's capacity until the
    keys fit: a dump written after growth loads into a table built with
    the original (smaller) capacity.  The lookup raises before it creates
    any slot, so a retry sees the index unchanged."""
    while True:
        try:
            return table.key_index.lookup(keys)
        except CapacityError:
            table.grow()
            log.info("table grew to %d rows per shard",
                     table.key_index.capacity_per_shard)


def _index_arrays(key_index):
    """``(keys uint64, slots int64)`` in insertion order."""
    n = len(key_index)
    keys = np.fromiter(key_index.keys(), np.uint64, n)
    slots = np.fromiter((s for _, s in key_index.items()), np.int64, n)
    return keys, slots


def dump_table_text(table: SparseTable, path: str,
                    formatter: Optional[Formatter] = None,
                    fields: Optional[tuple] = None) -> int:
    """Write ``key\\tvalue`` lines for every occupied row in key-index
    insertion order; returns the count.

    With no ``formatter`` the value is the ``fields`` (default: the access
    method's pull fields), each a space-joined float vector, tab-separated,
    written by the native C++ writer when its library builds (else by
    ``default_formatter``).  A ``formatter`` gets every field's row.
    bfloat16 fields are upcast to float32 first, exactly.  Rows come from
    the unified view (hot rows first), which the slots index."""
    fields = tuple(fields or table.access.pull_fields)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if formatter is None:
        from swiftmpi_tpu_torch.data import native
        if native.available():
            keys, slots = _index_arrays(table.key_index)
            idx = torch.from_numpy(slots).to(table.device)
            arrs = [tensor_to_numpy(table.unified_rows(f, idx), upcast=True)
                    for f in fields]
            # every process holds the same replica: process 0 writes
            if not is_writer():
                return len(keys)
            return native.dump_rows_native(path, keys, arrs)
        formatter = default_formatter(fields)
    rows = {f: table.unified_rows_host(f, upcast=True)
            for f in table.access.fields}
    if not is_writer():
        return len(table.key_index)
    n = 0
    with open(path, "w") as f:
        for key, slot in table.key_index.items():
            row = {name: arr[slot] for name, arr in rows.items()}
            f.write(f"{key}\t{formatter(row)}\n")
            n += 1
    return n


def load_table_text(table: SparseTable, path: str,
                    parser: Optional[Parser] = None,
                    shard_filter: Optional[int] = None,
                    fields: Optional[tuple] = None) -> int:
    """Read ``key\\tvalue`` lines into the table, creating slots for new
    keys (growing the table when they do not fit); with ``shard_filter``
    keep only the keys that shard owns.  Returns the rows loaded.

    With no ``parser`` the rows are fixed-layout ``fields`` float vectors,
    read by the native C++ reader when its library builds (else by
    ``default_parser``).  Fields the lines do not carry keep their
    values."""
    fields = tuple(fields or table.access.pull_fields)
    if parser is None:
        from swiftmpi_tpu_torch.data import native
        if native.available():
            dims = [table.access.fields[f].dim for f in fields]
            keys, arrs = native.load_rows_native(path, dims)
            return _load_rows(table, keys, dict(zip(fields, arrs)),
                              shard_filter)
        parser = default_parser(fields)
    keys, rests = [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            key_s, _, rest = line.partition("\t")
            keys.append(int(key_s))
            rests.append(rest)
    parsed: Dict[str, list] = {}
    for rest in rests:
        for fname, value in parser(rest).items():
            parsed.setdefault(fname, []).append(
                np.asarray(value, np.float32).ravel())
    blocks = {f: np.stack(v) for f, v in parsed.items()}
    return _load_rows(table, np.asarray(keys, np.uint64), blocks,
                      shard_filter)


def _load_rows(table: SparseTable, keys: np.ndarray,
               blocks: Dict[str, np.ndarray],
               shard_filter: Optional[int]) -> int:
    if shard_filter is not None and len(keys):
        keep = table.key_index.shard_of(keys) == shard_filter
        keys = keys[keep]
        blocks = {f: b[keep] for f, b in blocks.items()}
    if not len(keys):
        return 0
    slots = _lookup_growing(table, keys).astype(np.int64)
    n_hot = table.n_hot
    hot = slots < n_hot
    for fname, block in blocks.items():
        rows = torch.from_numpy(
            np.ascontiguousarray(block, np.float32).reshape(len(keys), -1))
        # unified slots: the hot plane below n_hot, the tail re-based
        if hot.any():
            table.write_rows(hot_name(fname), slots[hot],
                             rows[torch.from_numpy(hot)])
        if not hot.all():
            table.write_rows(fname, slots[~hot] - n_hot,
                             rows[torch.from_numpy(~hot)])
    return len(keys)


# -- binary (full fidelity, mid-training) ----------------------------------

# orphaned tmp files older than this are swept on the next save; younger
# ones may belong to a concurrent writer mid-savez and must be left alone
_TMP_SWEEP_AGE_S = 300.0
# beyond this age a tmp is swept even if its embedded pid is alive: the
# pid has almost certainly been recycled by an unrelated process
_TMP_SWEEP_FORCE_AGE_S = 7 * 86400.0

# every payload array gets a sibling ``__crc__<name>`` uint32 so loaders
# can detect torn or bit-rotted writes (np.load checks no zip CRC)
_CRC_PREFIX = "__crc__"


def npz_path(path: str) -> str:
    """Canonical on-disk name for a binary checkpoint (np.savez appends
    .npz itself; every reader and writer must agree on the same name)."""
    return path if path.endswith(".npz") else path + ".npz"


def _writer_alive(tmp_name: str) -> bool:
    """True if the pid embedded in ``<dst>.<pid>.tmp.npz`` is a live
    process: its in-progress write must not be swept."""
    try:
        pid = int(tmp_name.rsplit(".tmp.npz", 1)[0].rsplit(".", 1)[1])
        os.kill(pid, 0)
        return True
    except (ValueError, IndexError, ProcessLookupError):
        return False
    except PermissionError:     # exists, owned by someone else
        return True


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed CRC validation or is structurally unreadable.
    Recovery: fall back to an older generation
    (:func:`find_latest_valid_checkpoint`) or restart from scratch."""


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _sweep_stale_tmps(dst: str, mine: str) -> None:
    """Remove orphan tmps of killed writers: only when the writing pid is
    dead and the file has aged, or past the force age."""
    now = time.time()
    for stale in glob.glob(glob.escape(dst) + ".*.tmp.npz"):
        if stale == mine:
            continue
        try:
            age = now - os.path.getmtime(stale)
            if age > _TMP_SWEEP_FORCE_AGE_S or (
                    age > _TMP_SWEEP_AGE_S and not _writer_alive(stale)):
                os.unlink(stale)
        except OSError:
            pass


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_savez(dst: str, payload: Dict[str, np.ndarray]) -> None:
    """Crash-safe npz write: savez to a pid-unique tmp, fsync, rename,
    then fsync the directory, so a crash mid-write never clobbers the last
    good checkpoint and the rename survives power loss.  Every array gains
    a ``__crc__<name>`` checksum entry; orphan tmps of dead writers are
    swept first."""
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp.npz"   # unique per writer
    _sweep_stale_tmps(dst, tmp)
    full = dict(payload)
    for k in payload:
        full[_CRC_PREFIX + k] = np.uint32(_crc32(np.asarray(payload[k])))
    try:
        np.savez(tmp, **full)
        _fsync(tmp)
        os.replace(tmp, dst)
        try:
            _fsync(os.path.dirname(os.path.abspath(dst)))
        except OSError:
            pass                   # some filesystems refuse dir fsync
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def verify_checkpoint(path: str) -> None:
    """Validate every checksummed array of an npz checkpoint; raises
    :class:`CheckpointCorruptError` on a mismatch or an unreadable file.
    Files without ``__crc__`` entries (written before the CRCs) pass.  A
    missing file raises ``FileNotFoundError`` (absence is not
    corruption)."""
    p = npz_path(path)
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    try:
        with np.load(p) as z:
            names = set(z.files)
            for name in sorted(names):
                crc_key = _CRC_PREFIX + name
                if name.startswith(_CRC_PREFIX) or crc_key not in names:
                    continue
                want, got = int(z[crc_key]), _crc32(z[name])
                if got != want:
                    raise CheckpointCorruptError(
                        f"{p}: array {name!r} CRC mismatch "
                        f"(stored {want:#010x}, computed {got:#010x})")
    except CheckpointCorruptError:
        raise
    except Exception as e:   # noqa: BLE001 — zip, zlib or pickle damage
        raise CheckpointCorruptError(f"{p}: unreadable npz: {e!r}") from e


def _gen_path(dst: str, n: int) -> str:
    """Retained-generation name: ``ckpt.npz`` -> ``ckpt.g<n>.npz``."""
    return f"{dst[:-len('.npz')]}.g{n}.npz"


def _gen_files(dst: str) -> List[int]:
    """Existing generation numbers of ``dst``, ascending."""
    stem = dst[:-len(".npz")]
    gens = []
    for p in glob.glob(glob.escape(stem) + ".g*.npz"):
        try:
            gens.append(int(p[len(stem) + 2:-len(".npz")]))
        except ValueError:
            continue
    return sorted(gens)


def rotate_before_write(dst: str, retain: int) -> None:
    """Retention step 1, right before an atomic overwrite of ``dst``:
    rename the live checkpoint to the next generation so the overwrite
    cannot destroy the only valid copy.  No-op for ``retain <= 1`` or
    when ``dst`` does not exist."""
    if retain <= 1 or not os.path.exists(dst):
        return
    gens = _gen_files(dst)
    os.replace(dst, _gen_path(dst, (gens[-1] + 1) if gens else 1))


def prune_generations(dst: str, retain: int) -> None:
    """Retention step 2, after a successful write: keep the newest
    ``retain - 1`` generations (live file + k-1 generations = k)."""
    if retain <= 1:
        return
    for n in _gen_files(dst)[:-(retain - 1)]:
        try:
            os.unlink(_gen_path(dst, n))
        except OSError:
            pass


def find_latest_valid_checkpoint(path: str) -> Optional[str]:
    """Newest checkpoint of ``path`` that passes CRC validation: the live
    file, else the retained generations newest first.  Returns a loadable
    path or None; corrupt candidates are logged and skipped."""
    dst = npz_path(path)
    for cand in [dst] + [_gen_path(dst, n)
                         for n in reversed(_gen_files(dst))]:
        if not os.path.exists(cand):
            continue
        try:
            verify_checkpoint(cand)
            return cand
        except CheckpointCorruptError as e:
            log.warning("skipping corrupt checkpoint %s: %s", cand, e)
    return None


def save_checkpoint(table: SparseTable, path: str,
                    extra: Optional[Dict[str, np.ndarray]] = None,
                    retain: int = 1) -> None:
    """npz of every field (the AdaGrad sums and the ``@ef`` and
    ``@rowver`` planes included), the key index and the ``extra`` arrays
    (e.g. the iteration counter): resume-exact,
    unlike the reference's text dump.  ``retain > 1`` keeps a last-k
    window: the previous live checkpoint becomes ``<path>.g<n>.npz`` and
    older generations beyond ``retain - 1`` are pruned.  With telemetry
    on it is the ``checkpoint_save`` span and books ``checkpoint/saves``."""
    with obs.span("checkpoint_save"):
        _save_checkpoint(table, path, extra, retain)
    reg = obs.get_registry()
    if reg.enabled:
        reg.counter("checkpoint/saves").inc()


def _save_checkpoint(table: SparseTable, path: str, extra, retain: int
                     ) -> None:
    keys, slots = _index_arrays(table.key_index)
    payload = {}
    for f in table.state:
        # np.savez has no bfloat16; float32 holds every bfloat16 exactly
        # (the int32 @rowver plane is saved as it is)
        payload[f"field__{f}"] = tensor_to_numpy(table.global_rows(f),
                                                 upcast=True)
    payload["keys"] = keys
    payload["slots"] = slots
    payload["num_shards"] = np.int64(table.key_index.num_shards)
    payload["capacity_per_shard"] = np.int64(
        table.key_index.capacity_per_shard)
    # the hot-head size travels with the checkpoint, so a load can refuse
    # a table built under another frequency split
    payload["n_hot"] = np.int64(table.n_hot)
    for k, v in (extra or {}).items():
        payload[f"extra__{k}"] = np.asarray(v)
    if not is_writer():        # every process computed; process 0 writes
        return
    dst = npz_path(path)
    rotate_before_write(dst, retain)
    atomic_savez(dst, payload)
    prune_generations(dst, retain)


def load_checkpoint(table: SparseTable, path: str,
                    verify: bool = True) -> Dict[str, np.ndarray]:
    """Restore the table's fields and key index from ``save_checkpoint``
    output (either package's), copying into the existing tensors; returns
    the ``extra`` arrays.  ``verify`` (default on) CRC-validates the file
    first and raises :class:`CheckpointCorruptError` instead of restoring
    damaged state.  A checkpoint of a larger capacity (written after a
    growth) grows the table first; a smaller capacity or another shard
    count raises ``ValueError``.  With telemetry on it is the
    ``checkpoint_restore`` span and books ``checkpoint/restores``."""
    with obs.span("checkpoint_restore"):
        extra = _load_checkpoint(table, path, verify)
    reg = obs.get_registry()
    if reg.enabled:
        reg.counter("checkpoint/restores").inc()
    return extra


def _load_checkpoint(table: SparseTable, path: str,
                     verify: bool) -> Dict[str, np.ndarray]:
    if verify:
        verify_checkpoint(path)
    ki = table.key_index
    with np.load(npz_path(path)) as z:
        if int(z["num_shards"]) != ki.num_shards:
            raise ValueError(
                f"checkpoint has {int(z['num_shards'])} shards, table has "
                f"{ki.num_shards}")
        n_hot = int(z["n_hot"]) if "n_hot" in z.files else 0
        names = [n[len("field__"):] for n in z.files
                 if n.startswith("field__")]
        saved_ef = sorted(n for n in names if is_ef_field(n))
        if saved_ef != sorted(table.ef_fields):
            raise ValueError(
                f"checkpoint EF residual planes {saved_ef} do not match the "
                f"table's {sorted(table.ef_fields)}: restore with the same "
                "[cluster] wire_quant setting the checkpoint was written "
                "under (or rebuild the model with matching error-feedback "
                "arming)")
        if n_hot != table.n_hot:
            raise ValueError(
                f"checkpoint has n_hot={n_hot}, table has "
                f"n_hot={table.n_hot}: the hot/cold partition is fixed at "
                "vocab build; rebuild the model under the same frequency "
                "split before restoring")
        if set(names) - {ROWVER_KEY} != set(table.state) - {ROWVER_KEY}:
            raise ValueError(f"checkpoint fields {sorted(names)} do not "
                             f"match the table's {sorted(table.state)}")
        saved_cap = int(z["capacity_per_shard"])
        if saved_cap < ki.capacity_per_shard:
            raise ValueError(
                f"checkpoint capacity_per_shard {saved_cap} is smaller "
                f"than the table's {ki.capacity_per_shard}; shrinking on "
                "load is not supported")
        if saved_cap > ki.capacity_per_shard:
            # written after a growth: take its capacity; every row is
            # overwritten just below, so the new rows' draws are spent
            table.grow(saved_cap)
        if ROWVER_KEY in names:
            table.ensure_row_versions()
        elif ROWVER_KEY in table.state:
            # versions from before the plane was armed: all "never applied"
            table.assign(ROWVER_KEY, torch.zeros(
                (ki.capacity, 1), dtype=torch.int32))
        for name in names:
            table.assign(name, torch.from_numpy(z[f"field__{name}"]))
        ki.restore(z["keys"], z["slots"])
        return {k[len("extra__"):]: z[k] for k in z.files
                if k.startswith("extra__")}
