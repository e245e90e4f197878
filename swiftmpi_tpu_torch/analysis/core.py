"""Lint engine of the port: file loading, suppression directives,
baseline, runner (counterpart of ``swiftmpi_tpu/analysis/core.py``).

Deliberately dependency-free (stdlib ``ast`` only) so the gate runs in
any environment the repo imports in — no torch, no CUDA.  Rules live in
:mod:`swiftmpi_tpu_torch.analysis.rules`; this module owns the mechanics
every rule shares:

* :class:`LintFile` — parsed source + per-line suppression directives.
  A directive on a block header (``def``/``class``/``with``/``for``)
  expands to the whole block's line span, so one justified comment can
  cover e.g. a trainer-thread-only device function in a serve module.
* fingerprints — ``sha1(rule | relpath | normalized line text | k)``
  where ``k`` disambiguates identical lines.  Line-content-based, so a
  baseline survives unrelated edits that shift line numbers.
* baseline — checked-in JSON of grandfathered fingerprints with a
  required ``justification`` string per entry (the "benign legacy
  pattern" contract; an empty baseline is the healthy state).  The
  port's baseline is its own file, :data:`BASELINE_NAME` under the
  repository root; the JAX package's ``lint_baseline.json`` is not read.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: the port's baseline, relative to the repository root
BASELINE_NAME = "swiftmpi_tpu_torch/analysis/lint_baseline.json"
JSON_SCHEMA = "smtpu-lint/1"

_DIRECTIVE_RE = re.compile(
    r"#\s*smtpu-lint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Z0-9\-]+(?:\s*,\s*[A-Z0-9\-]+)*)")

#: statements whose header-line directive covers the whole block
_BLOCK_STMTS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.With, ast.For, ast.While, ast.If, ast.Try)


@dataclass
class Finding:
    rule: str
    path: str            # repo-relative, forward slashes
    line: int
    col: int
    message: str
    fingerprint: str = ""

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "fingerprint": self.fingerprint}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}: {self.message}")


class LintFile:
    """One parsed source file plus its suppression machinery."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        #: line -> set of rule ids disabled on that line
        self._line_disables: Dict[int, Set[str]] = {}
        self._file_disables: Set[str] = set()
        try:
            self.tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            self.parse_error = e
            return
        self._collect_directives()

    # -- directives -------------------------------------------------------
    def _collect_directives(self) -> None:
        raw: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _DIRECTIVE_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if m.group(1) == "disable-file":
                self._file_disables |= rules
            else:
                raw.setdefault(i, set()).update(rules)
        self._line_disables = dict(raw)
        if not raw or self.tree is None:
            return
        # block-header directives cover the statement's full line span
        for node in ast.walk(self.tree):
            if not isinstance(node, _BLOCK_STMTS):
                continue
            header = raw.get(node.lineno)
            # a decorated def's directive may sit on the first decorator
            if header is None and getattr(node, "decorator_list", None):
                header = raw.get(node.decorator_list[0].lineno)
            if header is None:
                continue
            for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
                self._line_disables.setdefault(ln, set()).update(header)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self._file_disables:
            return True
        return rule in self._line_disables.get(line, set())

    # -- fingerprints -----------------------------------------------------
    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


def fingerprint(rule: str, rel: str, line_text: str, occurrence: int) -> str:
    norm = re.sub(r"\s+", " ", line_text.strip())
    h = hashlib.sha1(
        f"{rule}|{rel}|{norm}|{occurrence}".encode()).hexdigest()
    return h[:16]


@dataclass
class LintContext:
    """Shared lookups rules may need (resolved once per run)."""

    root: str
    #: the knob reference for KNOB-DOC: docs/OPERATIONS.md (read, never
    #: edited) followed by the README's port section, where a knob that
    #: only the port reads is documented ("" when both are absent)
    operations_md: str = ""
    #: extra knob-doc text sources (ARCHITECTURE.md is NOT consulted —
    #: OPERATIONS.md is the operator-facing contract)
    extras: dict = field(default_factory=dict)

    @classmethod
    def for_root(cls, root: str) -> "LintContext":
        text = ""
        ops = os.path.join(root, "docs", "OPERATIONS.md")
        if os.path.exists(ops):
            with open(ops, encoding="utf-8") as f:
                text = f.read()
        readme = os.path.join(root, "README.md")
        if os.path.exists(readme):
            with open(readme, encoding="utf-8") as f:
                text += "\n" + port_section(f.read())
        return cls(root=root, operations_md=text)


#: the heading that opens the README's section on the port
PORT_SECTION = "## PyTorch/CUDA port"


def port_section(readme: str) -> str:
    """The README's port section: from :data:`PORT_SECTION` to the next
    second-level heading ("" when the README has none)."""
    at = readme.find(PORT_SECTION)
    if at < 0:
        return ""
    end = readme.find("\n## ", at + len(PORT_SECTION))
    return readme[at:] if end < 0 else readme[at:end]


# -- file collection --------------------------------------------------------

_DEFAULT_SCOPES = ("swiftmpi_tpu_torch", "chip_smoke.py")
_EXCLUDE_DIRS = {"__pycache__", ".git", "runs"}


def default_paths(root: str) -> List[str]:
    """The port's lint scope: the package and ``chip_smoke.py``.
    tests/ is deliberately out — fixtures there reproduce violations
    on purpose."""
    out: List[str] = []
    for scope in _DEFAULT_SCOPES:
        p = os.path.join(root, scope)
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def load_files(paths: Sequence[str], root: str) -> List[LintFile]:
    files = []
    for p in paths:
        rel = os.path.relpath(p, root)
        with open(p, encoding="utf-8") as f:
            src = f.read()
        files.append(LintFile(p, rel, src))
    return files


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> entry.  Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: str, findings: Iterable[Finding],
                   justification: str = "TODO: justify or fix") -> int:
    """Write a baseline of grandfathered findings.  The default
    ``justification`` is a deliberate placeholder: an entry still
    carrying it (or any empty/TODO text) is NOT a justified suppression,
    and :func:`run_lint` surfaces it as a ``BASELINE-JUSTIFY`` finding
    until a real reason is written in."""
    entries = [{"rule": f.rule, "path": f.path, "line_hint": f.line,
                "fingerprint": f.fingerprint,
                "justification": justification}
               for f in findings]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"schema": JSON_SCHEMA, "findings": entries}, f,
                  indent=2, sort_keys=True)
        f.write("\n")
    return len(entries)


def _unjustified(entry: dict) -> bool:
    """True when a baseline entry's justification is missing, blank, or
    still the ``write_baseline`` placeholder (any text starting with
    ``TODO``, case-insensitive)."""
    j = str(entry.get("justification") or "").strip()
    return not j or j.upper().startswith("TODO")


# -- runner -----------------------------------------------------------------

def run_lint(paths: Optional[Sequence[str]] = None,
             root: Optional[str] = None,
             rules: Optional[Sequence] = None,
             baseline: Optional[Dict[str, dict]] = None,
             ) -> Tuple[List[Finding], List[Finding]]:
    """Run ``rules`` over ``paths``; returns ``(new, baselined)``.

    Findings suppressed by inline directives are dropped entirely;
    findings whose fingerprint appears in ``baseline`` land in the
    second list.  Fingerprint occurrence counters are assigned per
    (rule, file, normalized line text) in file order, so two identical
    offending lines get distinct stable fingerprints.
    """
    from swiftmpi_tpu_torch.analysis.rules import RULES
    if root is None:
        root = repo_root()
    if paths is None:
        paths = default_paths(root)
    if rules is None:
        rules = RULES
    ctx = LintContext.for_root(root)
    baseline = baseline or {}
    new: List[Finding] = []
    old: List[Finding] = []
    for lf in load_files(paths, root):
        if lf.parse_error is not None:
            e = lf.parse_error
            new.append(Finding("PARSE", lf.rel, e.lineno or 0, 0,
                               f"syntax error: {e.msg}",
                               fingerprint("PARSE", lf.rel, e.msg or "", 0)))
            continue
        per_file: List[Finding] = []
        for rule in rules:
            for f in rule.check(lf, ctx):
                if lf.suppressed(f.rule, f.line):
                    continue
                per_file.append(f)
        # stable fingerprints: occurrence index per identical key
        seen: Dict[Tuple[str, str], int] = {}
        for f in sorted(per_file, key=lambda f: (f.line, f.col, f.rule)):
            text = lf.line_text(f.line)
            key = (f.rule, re.sub(r"\s+", " ", text))
            k = seen.get(key, 0)
            seen[key] = k + 1
            f.fingerprint = fingerprint(f.rule, lf.rel, text, k)
            entry = baseline.get(f.fingerprint)
            if entry is None:
                new.append(f)
                continue
            old.append(f)
            if _unjustified(entry):
                # a suppression without a reason is not a suppression —
                # the placeholder write_baseline stamps in must be
                # replaced by a human-written justification, or the
                # finding keeps gating
                bj = Finding(
                    "BASELINE-JUSTIFY", f.path, f.line, f.col,
                    f"baseline entry for {f.rule} ({f.fingerprint}) has "
                    "an empty or placeholder justification — write the "
                    f"reason into {BASELINE_NAME} or fix the finding",
                    fingerprint("BASELINE-JUSTIFY", lf.rel, text, k))
                if not lf.suppressed("BASELINE-JUSTIFY", f.line) and \
                        bj.fingerprint not in baseline:
                    new.append(bj)
    return new, old


def repo_root() -> str:
    """The repo checkout containing this package
    (…/swiftmpi_tpu_torch/..)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
