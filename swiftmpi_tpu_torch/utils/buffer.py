"""Binary / text serialization buffers (counterpart of
``swiftmpi_tpu/utils/buffer.py``).

Equivalent of the reference wire-format layer
(the reference's ``src/utils/Buffer.h``): ``BinaryBuffer`` is a growable byte
buffer with a read cursor and raw little-endian scalar encoding (no tags, no
lengths — Buffer.h:169-230); ``TextBuffer`` is the line/token-oriented
variant (Buffer.h:236-318).

There is no socket wire, so these exist for binary blobs such as
``HashFrag.serialize`` and for byte-exact interchange with artifacts the
reference's BinaryBuffer (and the JAX package's copy) produced.  Python's
``struct`` gives the same little-endian memcpy semantics; buffer growth is
``bytearray``'s amortized doubling (Buffer.h:219-228).  Host numpy only.
"""

from __future__ import annotations

import struct
from typing import Union

import numpy as np

_FMT = {
    "int16": "<h", "uint16": "<H",
    "int32": "<i", "uint32": "<I",
    "int64": "<q", "uint64": "<Q",
    "float32": "<f", "float64": "<d",
    "bool": "<?", "byte": "<B", "char": "<b",
}


class BinaryBuffer:
    """Growable byte buffer with a read cursor (Buffer.h:15-116,169-230)."""

    def __init__(self, data: Union[bytes, bytearray, None] = None):
        self._buf = bytearray(data or b"")
        self._cursor = 0

    # -- writes -----------------------------------------------------------
    def put(self, value, dtype: str) -> "BinaryBuffer":
        self._buf += struct.pack(_FMT[dtype], value)
        return self

    def put_int32(self, v): return self.put(int(v), "int32")
    def put_uint32(self, v): return self.put(int(v), "uint32")
    def put_int64(self, v): return self.put(int(v), "int64")
    def put_uint64(self, v): return self.put(int(v), "uint64")
    def put_float(self, v): return self.put(float(v), "float32")
    def put_double(self, v): return self.put(float(v), "float64")
    def put_bool(self, v): return self.put(bool(v), "bool")

    def put_array(self, arr: np.ndarray) -> "BinaryBuffer":
        """Raw contiguous dump, matching repeated scalar << in the reference
        (e.g. word2vec.h:120-132 serializes vectors element by element)."""
        self._buf += np.ascontiguousarray(arr).tobytes()
        return self

    # -- reads ------------------------------------------------------------
    def get(self, dtype: str):
        fmt = _FMT[dtype]
        size = struct.calcsize(fmt)
        (value,) = struct.unpack_from(fmt, self._buf, self._cursor)
        self._cursor += size
        return value

    def get_int32(self): return self.get("int32")
    def get_uint32(self): return self.get("uint32")
    def get_int64(self): return self.get("int64")
    def get_uint64(self): return self.get("uint64")
    def get_float(self): return self.get("float32")
    def get_double(self): return self.get("float64")
    def get_bool(self): return self.get("bool")

    def get_array(self, count: int, dtype) -> np.ndarray:
        dt = np.dtype(dtype)
        nbytes = count * dt.itemsize
        arr = np.frombuffer(
            bytes(self._buf[self._cursor:self._cursor + nbytes]),
            dtype=dt, count=count)
        self._cursor += nbytes
        return arr

    # -- bookkeeping ------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self._buf)

    @property
    def read_finished(self) -> bool:
        """Reference ``finished()``: cursor consumed the whole buffer."""
        return self._cursor >= len(self._buf)

    def to_bytes(self) -> bytes:
        return bytes(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self._cursor = 0


class TextBuffer:
    """Line/token text buffer (Buffer.h:236-318)."""

    def __init__(self, text: str = ""):
        self._parts = [text] if text else []

    def put(self, *values) -> "TextBuffer":
        for v in values:
            self._parts.append(str(v))
        return self

    def put_line(self, line: str) -> "TextBuffer":
        self._parts.append(line + "\n")
        return self

    def to_string(self) -> str:
        return "".join(self._parts)

    def tokens(self):
        return self.to_string().split()

    def clear(self) -> None:
        self._parts.clear()
