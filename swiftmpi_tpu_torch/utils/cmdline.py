"""``-key value`` command-line parser (the port's own copy of
``swiftmpi_tpu/utils/cmdline.py``).

Equivalent of the reference's libFM-derived ``fms::CMDLine``
(`src/utils/CMDLine.h`): flags are registered with help text,
parsed from ``-key value`` pairs (a bare trailing flag is treated as
value-less), and queried with ``get_value``/``has_parameter``.  Built on top
of plain argv handling rather than argparse so the reference CLIs'
single-dash long flags (``-config``, ``-data``, ``-niters``, ``-output``,
``-mode``) work verbatim (reference w2v.cpp:8-17, lr.cpp:413-447).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence


class CMDLine:
    def __init__(self, argv: Optional[Sequence[str]] = None):
        argv = list(sys.argv if argv is None else argv)
        self._help: Dict[str, str] = {}
        self._values: Dict[str, str] = {}
        self._prog = argv[0] if argv else ""
        def is_flag(tok: str) -> bool:
            # "-key" is a flag; "-0.5" / "-3" are (negative-number) values.
            return (tok.startswith("-") and len(tok) > 1
                    and not tok[1].isdigit() and tok[1] != ".")

        i = 1
        while i < len(argv):
            tok = argv[i]
            if is_flag(tok):
                key = tok.lstrip("-")
                if i + 1 < len(argv) and not is_flag(argv[i + 1]):
                    self._values[key] = argv[i + 1]
                    i += 2
                else:
                    self._values[key] = ""
                    i += 1
            else:
                i += 1

    def register_parameter(self, key: str, help_text: str) -> str:
        self._help[key] = help_text
        return key

    # libFM-style camelCase aliases used by the reference call sites
    registerParameter = register_parameter

    def has_parameter(self, key: str) -> bool:
        return key in self._values

    hasParameter = has_parameter

    def get_value(self, key: str, default: Optional[str] = None) -> str:
        if key in self._values:
            return self._values[key]
        if default is not None:
            return default
        raise KeyError(f"missing command-line flag -{key}")

    getValue = get_value

    def print_help(self, out=None) -> None:
        # resolved per call, so a redirected sys.stdout is honoured
        out = sys.stdout if out is None else out
        out.write(f"usage: {self._prog} [options]\n")
        for key, text in self._help.items():
            out.write(f"  -{key:<12} {text}\n")

    def keys(self) -> List[str]:
        return list(self._values)
