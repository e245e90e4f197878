"""INI-compatible configuration system (the port's own copy of
``swiftmpi_tpu/utils/config.py``; the port imports nothing of the JAX
package).

Re-implementation of the reference config layer
(`src/utils/ConfigParser.h:84-115`): the same on-disk format —
``[section]`` headers, ``key: value`` (or ``key value``) entries, ``#``
comments, and ``import <path>`` includes — so reference ``demo.conf`` files
parse unchanged.  Typed access mirrors ``Item::to_int32/to_float/to_string/
to_bool`` (ConfigParser.h:28-48); a process-wide ``global_config()`` singleton
mirrors ConfigParser.h:130-133.

Differences by design (not a port):
  * values are stored per-(section, key); the reference flattens late.
  * missing keys raise ``KeyError`` with the section/key named instead of a
    glog CHECK-abort.
  * ``as_dict()`` and programmatic ``set()`` support config-from-code, which
    the tests and apps use heavily (no global mutable state required).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, Optional, Tuple


class ConfigError(KeyError):
    """Raised when a requested key/section is absent or untyped."""


class Item:
    """A single typed config value (reference ConfigParser.h:21-50)."""

    __slots__ = ("raw",)

    def __init__(self, raw: str):
        self.raw = raw.strip()

    def to_string(self) -> str:
        return self.raw

    def to_int32(self) -> int:
        return int(self.raw)

    def to_float(self) -> float:
        return float(self.raw)

    def to_bool(self) -> bool:
        v = self.raw.lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off", ""):
            return False
        raise ConfigError(f"not a bool: {self.raw!r}")

    def __repr__(self) -> str:  # pragma: no cover
        return f"Item({self.raw!r})"


class ConfigParser:
    """Sectioned key/value config with ``import`` includes.

    Accepts both ``key: value`` and ``key value`` line forms, ``#`` comments
    (full-line or trailing), and nested ``import path`` directives resolved
    relative to the importing file (reference ConfigParser.h:84-115).
    """

    def __init__(self, path: Optional[str] = None):
        self._values: Dict[Tuple[str, str], Item] = {}
        self._lock = threading.Lock()
        if path is not None:
            self.load_conf(path)
            self.parse()

    # -- loading ----------------------------------------------------------
    def load_conf(self, path: str) -> "ConfigParser":
        self._pending_path = path
        return self

    def parse(self) -> "ConfigParser":
        path = getattr(self, "_pending_path", None)
        if path is None:
            raise ConfigError("load_conf() must be called before parse()")
        self._parse_file(path)
        return self

    def _parse_file(self, path: str, section: str = "") -> str:
        """Parse one file; returns the trailing section so that, as in the
        reference parser's mutable ``cur_session`` state, a section opened
        inside an imported file stays current after the import returns."""
        base = os.path.dirname(os.path.abspath(path))
        with open(path, "r") as f:
            for lineno, line in enumerate(f, 1):
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                if line.startswith("[") and line.endswith("]"):
                    section = line[1:-1].strip()
                    continue
                if line.split(None, 1)[0] == "import":
                    target = line[len("import"):].strip()
                    if not os.path.isabs(target):
                        target = os.path.join(base, target)
                    section = self._parse_file(target, section)
                    continue
                if ":" in line:
                    key, _, value = line.partition(":")
                else:
                    parts = line.split(None, 1)
                    if len(parts) != 2:
                        raise ConfigError(
                            f"{path}:{lineno}: cannot parse line {line!r}")
                    key, value = parts
                self.set(section, key.strip(), value.strip())
        return section

    # -- access -----------------------------------------------------------
    def set(self, section: str, key: str, value) -> None:
        with self._lock:
            self._values[(section, key)] = Item(str(value))

    def get(self, section: str, key: str) -> Item:
        with self._lock:
            try:
                return self._values[(section, key)]
            except KeyError:
                raise ConfigError(
                    f"config key [{section}] {key} not set") from None

    def has(self, section: str, key: str) -> bool:
        with self._lock:
            return (section, key) in self._values

    def get_or(self, section: str, key: str, default) -> Item:
        if not self.has(section, key):
            return Item(str(default))
        return self.get(section, key)

    def section(self, section: str) -> Dict[str, Item]:
        with self._lock:
            return {k: v for (s, k), v in self._values.items()
                    if s == section}

    def update(self, mapping: Dict[str, Dict[str, object]]) -> "ConfigParser":
        """Bulk-set from ``{section: {key: value}}`` (config-from-code)."""
        for sec, kv in mapping.items():
            for k, v in kv.items():
                self.set(sec, k, v)
        return self

    def as_dict(self) -> Dict[str, Dict[str, str]]:
        out: Dict[str, Dict[str, str]] = {}
        with self._lock:
            for (sec, key), item in self._values.items():
                out.setdefault(sec, {})[key] = item.raw
        return out

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def __iter__(self) -> Iterator[Tuple[str, str, str]]:
        with self._lock:
            items = list(self._values.items())
        for (sec, key), item in items:
            yield sec, key, item.raw

    def __repr__(self) -> str:  # pragma: no cover
        lines = [f"[{s}] {k}: {v}" for s, k, v in self]
        return "ConfigParser(\n  " + "\n  ".join(lines) + "\n)"


_GLOBAL_CONFIG: Optional[ConfigParser] = None
_GLOBAL_LOCK = threading.Lock()


def global_config() -> ConfigParser:
    """Process-wide config singleton (reference ConfigParser.h:130-133)."""
    global _GLOBAL_CONFIG
    with _GLOBAL_LOCK:
        if _GLOBAL_CONFIG is None:
            _GLOBAL_CONFIG = ConfigParser()
        return _GLOBAL_CONFIG


def reset_global_config() -> None:
    """Testing hook: drop the singleton so each test starts clean."""
    global _GLOBAL_CONFIG
    with _GLOBAL_LOCK:
        _GLOBAL_CONFIG = None
