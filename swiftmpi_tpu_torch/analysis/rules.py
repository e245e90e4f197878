"""The invariant rules over the port (counterpart of
``swiftmpi_tpu/analysis/rules.py``).  Each encodes one hard-won repo
contract; the origin incident and enforcement rationale per rule live in
docs/ARCHITECTURE.md "Invariant catalog".  LOCK-GUARD, EPOCH-GUARD,
TELEMETRY-CATALOG, LEDGER-MONOTONIC, KNOB-DOC and PLAN-DISPATCH check
host code the port copied, as the JAX package's do; READER-PURE-HOST,
PRODUCER-NO-RNG and PRODUCER-NO-DEVICE check for torch's device and
generator calls where the JAX rules check for ``jax``'s.  DONATE-ESCAPE
has no counterpart: torch donates no buffers, and the port's steps
write their tables in place.

Rules are deliberately *syntactic with narrow scopes* rather than
whole-program dataflow: each invariant names the files that carry it
(the serve read path, the pipeline producer, the transfer ledger), so
a per-file AST pass with light intra-function tracking catches the
regression classes that actually happened without drowning the gate in
false positives.  Where a rule cannot decide statically (a series name
held in a bare variable), it stays silent rather than guessing — the
fixtures in tests/test_torch_lint.py pin exactly what each rule sees.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from swiftmpi_tpu_torch.analysis.core import Finding, LintContext, LintFile

# ---------------------------------------------------------------------------
# shared AST helpers


def attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted chain for Name/Attribute trees: ``torch.cuda.synchronize`` —
    None when the root is not a plain Name (calls, subscripts...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    p: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            p[child] = node
    return p


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _target_names(target: ast.AST) -> Set[str]:
    """Plain names (re)bound by an assignment target (tuples unpacked)."""
    out: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            out.add(n.id)
    return out


def _target_chains(target: ast.AST) -> Set[str]:
    """Dotted chains (self.x ...) rebound by an assignment target."""
    out: Set[str] = set()
    if isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            out |= _target_chains(e)
    else:
        c = attr_chain(target)
        if c:
            out.add(c)
    return out


class Rule:
    id: str = ""
    description: str = ""

    def check(self, f: LintFile, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, f: LintFile, node: ast.AST, msg: str) -> Finding:
        return Finding(self.id, f.rel, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), msg)




# ---------------------------------------------------------------------------
# READER-PURE-HOST

#: the serve read path: reader threads, the shipper's replicas, the query
#: helpers and the snapshot they read (the snapshot's one device-to-host
#: copy runs on the trainer thread inside ``parameter.sparse_table``)
_SERVE_FILES = ("serve/snapshot.py", "serve/reader.py", "serve/query.py",
                "serve/shipper.py")


def _imported_modules(node) -> List[str]:
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    return [node.module or ""]


def _is_cuda_string(node) -> bool:
    s = _const_str(node)
    return s is not None and (s == "cuda" or s.startswith("cuda:"))


class ReaderPureHost(Rule):
    """Serve read-path modules are pure host: no ``torch`` import, no
    ``torch.`` op and no CUDA placement (``.cuda()``, a ``"cuda"``
    device).  Reader threads launching device work race the trainer's
    steps for the card (the JAX package's rendezvous-deadlock class, and on
    the card a torn read of a table the next step writes in place); a
    snapshot reaches the host through the trainer thread's copy
    (``parameter.sparse_table.state_to_numpy``).  The trainer-only
    device top-k opts out with a block directive, as in the JAX
    package."""

    id = "READER-PURE-HOST"
    description = "device op reachable from the serve read path"

    def check(self, f, ctx):
        if not f.rel.endswith(_SERVE_FILES):
            return
        parents = parent_map(f.tree)
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for m in _imported_modules(node):
                    if m.split(".")[0] == "torch":
                        yield self.finding(
                            f, node,
                            f"import of `{m}` in a pure-host serve "
                            "module — readers must never touch the "
                            "device runtime")
            elif isinstance(node, (ast.Name, ast.Attribute)):
                if isinstance(parents.get(node), ast.Attribute):
                    continue
                chain = attr_chain(node)
                if not chain or chain.split(".")[0] != "torch":
                    continue
                yield self.finding(
                    f, node,
                    f"`{chain}` in a pure-host serve module — reader "
                    "threads must not launch device work; read the "
                    "snapshot's host planes instead")
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr == "cuda":
                    yield self.finding(
                        f, node,
                        "`.cuda()` in a pure-host serve module — readers "
                        "must never place data on the card")
                elif any(_is_cuda_string(a) for a in node.args) or any(
                        _is_cuda_string(k.value) for k in node.keywords):
                    yield self.finding(
                        f, node,
                        "a `\"cuda\"` device in a pure-host serve module "
                        "— readers must never place data on the card")


# ---------------------------------------------------------------------------
# PRODUCER-NO-RNG / PRODUCER-NO-DEVICE

_PIPELINE_SUFFIX = "io/pipeline.py"

#: generator and sampling chains: numpy's, the stdlib's and torch's
_RNG_PREFIXES = ("np.random", "numpy.random", "random.", "torch.random",
                 "torch.Generator", "torch.manual_seed", "torch.seed",
                 "torch.rand", "torch.randn", "torch.randint",
                 "torch.randperm", "torch.bernoulli", "torch.multinomial",
                 "torch.normal", "torch.poisson",
                 "torch.cuda.manual_seed", "torch.cuda.seed")


class ProducerNoRng(Rule):
    """The pipeline producer owns no RNG: every draw happens on the
    consumer in consumption order (the bit-identity contract of
    ``pipeline``/``inner_steps``), so nothing under io/pipeline.py may
    touch a generator — numpy's, the stdlib's or torch's."""

    id = "PRODUCER-NO-RNG"
    description = "RNG use inside the input-pipeline producer module"

    def check(self, f, ctx):
        if not f.rel.endswith(_PIPELINE_SUFFIX):
            return
        parents = parent_map(f.tree)
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.Name, ast.Attribute)):
                if isinstance(parents.get(node), ast.Attribute):
                    continue
                chain = attr_chain(node) or ""
                if chain.startswith(_RNG_PREFIXES):
                    yield self.finding(
                        f, node,
                        f"`{chain}` in the pipeline module — the "
                        "producer owns no RNG; draw on the consumer in "
                        "consumption order")
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for m in _imported_modules(node):
                    if m == "random" or m.startswith(("torch.random",
                                                      "numpy.random")):
                        yield self.finding(
                            f, node,
                            f"import of `{m}` in the pipeline module — "
                            "the producer owns no RNG")


#: calls that read or set the thread's current or default device
_DEVICE_CONTEXT = ("torch.cuda.current_device", "torch.cuda.set_device",
                   "torch.set_default_device", "torch.get_default_device",
                   "torch.set_default_tensor_type")


class ProducerNoDevice(Rule):
    """The producer thread must not consult the thread's device context
    (the current CUDA device and the default device are the consumer
    thread's state) or place tensors implicitly: ``.cuda()`` with no
    device, ``.to("cuda")``, ``torch.device("cuda")`` or ``device="cuda"``
    pick whatever device the producer thread happens to have.  Every
    placement names the device the consumer captured at build time."""

    id = "PRODUCER-NO-DEVICE"
    description = ("implicit device placement / current-device consult "
                   "in the pipeline module")

    def check(self, f, ctx):
        if not f.rel.endswith(_PIPELINE_SUFFIX):
            return
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func) or ""
            fn = node.func
            if chain.startswith(_DEVICE_CONTEXT):
                yield self.finding(
                    f, node,
                    f"`{chain}` in the pipeline module — the current and "
                    "default device are the consumer thread's state; "
                    "use the device captured at pipeline build time")
            elif isinstance(fn, ast.Attribute) and fn.attr == "cuda" \
                    and not node.args and not node.keywords:
                yield self.finding(
                    f, node,
                    "`.cuda()` without a device in the pipeline module — "
                    "implicit placement reads the producer thread's "
                    "current device")
            elif any(_is_cuda_string(a) for a in node.args) or any(
                    _is_cuda_string(k.value) for k in node.keywords):
                yield self.finding(
                    f, node,
                    "a bare `\"cuda\"` device in the pipeline module — "
                    "name the device captured at pipeline build time")


# LEDGER-MONOTONIC

_LEDGER_KEYS = None  # resolved lazily from obs.catalog


def _ledger_keys() -> Set[str]:
    global _LEDGER_KEYS
    if _LEDGER_KEYS is None:
        from swiftmpi_tpu_torch.obs.catalog import TRANSFER_KEYS
        _LEDGER_KEYS = set(TRANSFER_KEYS) | {
            "window_fmt_dense", "window_fmt_sparse", "window_fmt_q",
            "window_fmt_bitmap", "window_fmt_sketch"}
    return _LEDGER_KEYS


class LedgerMonotonic(Rule):
    """Traffic ledgers are monotonic totals: backends never reset or
    assign counters (interval numbers are snapshot-and-subtract), and
    call sites outside the transfer layer use ``traffic_delta`` instead
    of hand-rolled subtraction (hand-rolling races the eager-count
    drain)."""

    id = "LEDGER-MONOTONIC"
    description = ("ledger counter reset, or hand-rolled traffic delta "
                   "outside transfer/")

    def check(self, f, ctx):
        in_transfer = "/transfer/" in "/" + f.rel
        if in_transfer:
            yield from self._check_backend(f)
        yield from self._check_hand_rolled(f)

    def _check_backend(self, f):
        keys = _ledger_keys()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        k = _const_str(t.slice)
                        if k in keys:
                            yield self.finding(
                                f, node,
                                f"assignment to ledger counter "
                                f"[{k!r}] — ledgers are monotonic "
                                "totals with no reset; use += and let "
                                "readers snapshot-and-subtract")
            elif isinstance(node, ast.AugAssign):
                if isinstance(node.target, ast.Subscript) and \
                        isinstance(node.op, ast.Sub):
                    k = _const_str(node.target.slice)
                    if k in keys:
                        yield self.finding(
                            f, node,
                            f"`-=` on ledger counter [{k!r}] — "
                            "monotonic totals never decrease")
            elif isinstance(node, ast.FunctionDef):
                if re.match(r"(reset|clear)_.*(traffic|ledger|wire)",
                            node.name):
                    yield self.finding(
                        f, node,
                        f"method `{node.name}` — there is no reset in "
                        "the ledger contract (monotonic totals; "
                        "readers use traffic_delta)")

    def _check_hand_rolled(self, f):
        scopes = [f.tree] + [n for n in ast.walk(f.tree)
                             if isinstance(n, (ast.FunctionDef,
                                               ast.AsyncFunctionDef))]
        for scope in scopes:
            tracked: Set[str] = set()
            for node in scope.body if isinstance(scope, ast.Module) \
                    else ast.walk(scope):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call) and \
                        isinstance(node.value.func, ast.Attribute) and \
                        node.value.func.attr in ("traffic",
                                                 "wire_traffic"):
                    for t in node.targets:
                        tracked |= _target_names(t)
            if len(tracked) < 2:
                continue
            for node in ast.walk(scope):
                if isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.Sub):
                    lr = (self._root(node.left), self._root(node.right))
                    if lr[0] in tracked and lr[1] in tracked and \
                            lr[0] != lr[1]:
                        yield self.finding(
                            f, node,
                            f"hand-rolled traffic delta "
                            f"`{lr[0]} - {lr[1]}` — use "
                            "Transfer.traffic_delta(since), which "
                            "reconstructs the interval without racing "
                            "the eager-count drain")

    @staticmethod
    def _root(node) -> Optional[str]:
        while isinstance(node, (ast.Subscript, ast.Call, ast.Attribute)):
            node = node.func if isinstance(node, ast.Call) else node.value
        if isinstance(node, ast.Name):
            return node.id
        return None


# ---------------------------------------------------------------------------
# TELEMETRY-CATALOG

_INSTRUMENT_ATTRS = ("counter", "gauge", "histogram")
_CATALOG_EXEMPT = ("obs/registry.py", "obs/catalog.py", "obs/recorder.py",
                   "analysis/")


class TelemetryCatalog(Rule):
    """Every telemetry series registered with a literal name must be
    declared in :mod:`swiftmpi_tpu_torch.obs.catalog` — catching label drift
    across the four transfer-backend mirrors (incl. the tpu backend's
    eager-drain paths) and dashboard-silent typos.  Dynamic f-string
    names must fall inside a declared prefix family; bare-variable
    names are invisible to the checker and pass."""

    id = "TELEMETRY-CATALOG"
    description = "telemetry series name not in the declared catalog"

    def check(self, f, ctx):
        if any(x in f.rel for x in _CATALOG_EXEMPT):
            return
        from swiftmpi_tpu_torch.obs import catalog
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            wrapper = None
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in _INSTRUMENT_ATTRS:
                wrapper = ""
            elif isinstance(fn, (ast.Attribute, ast.Name)):
                name = fn.attr if isinstance(fn, ast.Attribute) else fn.id
                if name == "_obs_inc":
                    wrapper = "transfer/"
                elif name == "_obs_count":
                    wrapper = ""
            if wrapper is None:
                continue
            for cand in self._name_candidates(node.args[0]):
                kind, value = cand
                if kind == "exact":
                    if not catalog.declared(wrapper + value):
                        yield self.finding(
                            f, node,
                            f"series `{wrapper + value}` is not "
                            "declared in swiftmpi_tpu_torch/obs/catalog.py — "
                            "declare it (or fix the typo) so the "
                            "four backend mirrors stay in sync")
                elif kind == "prefix":
                    if not catalog.declared_prefix(wrapper + value):
                        yield self.finding(
                            f, node,
                            f"dynamic series name with stem "
                            f"`{wrapper + value}` matches no declared "
                            "prefix family in obs/catalog.py")

    @staticmethod
    def _name_candidates(arg):
        s = _const_str(arg)
        if s is not None:
            yield ("exact", s)
            return
        if isinstance(arg, ast.IfExp):
            for side in (arg.body, arg.orelse):
                s = _const_str(side)
                if s is not None:
                    yield ("exact", s)
            return
        if isinstance(arg, ast.JoinedStr):
            stem = ""
            for v in arg.values:
                s = _const_str(v)
                if s is None:
                    break
                stem += s
            yield ("prefix", stem)
            return
        if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
            s = _const_str(arg.left)
            if s is not None:
                yield ("prefix", s)
        # bare variables: statically invisible, skip


# ---------------------------------------------------------------------------
# LOCK-GUARD

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_MUTATORS = {"append", "appendleft", "add", "clear", "pop", "popitem",
             "remove", "update", "extend", "insert", "discard",
             "setdefault"}


class LockGuard(Rule):
    """Fields annotated ``# guarded-by: <lock>`` on their ``__init__``
    assignment may only be mutated inside ``with self.<lock>:`` (any
    method but ``__init__``, which runs happens-before publication).
    Encodes the SnapshotPublisher swap contract: readers race
    ``_latest``/``_history``, so every write goes through the
    Condition."""

    id = "LOCK-GUARD"
    description = "guarded field mutated outside its lock"

    def check(self, f, ctx):
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(f, node)

    def _check_class(self, f, cls):
        guards: Dict[str, str] = {}
        init = None
        for meth in cls.body:
            if isinstance(meth, ast.FunctionDef) and \
                    meth.name == "__init__":
                init = meth
        if init is None:
            return
        for node in ast.walk(init):
            if isinstance(node, ast.Assign):
                m = _GUARD_RE.search(f.lines[node.lineno - 1]
                                     if node.lineno <= len(f.lines) else "")
                if not m:
                    continue
                for t in node.targets:
                    for c in _target_chains(t):
                        if c.startswith("self."):
                            guards[c[len("self."):]] = m.group(1)
        if not guards:
            return
        parents = parent_map(cls)
        for meth in cls.body:
            if not isinstance(meth, ast.FunctionDef) or \
                    meth.name == "__init__":
                continue
            for node in ast.walk(meth):
                field = self._mutated_field(node, guards)
                if field is None:
                    continue
                lock = guards[field]
                if not self._under_lock(node, parents, lock):
                    yield self.finding(
                        f, node,
                        f"`self.{field}` is guarded-by `{lock}` but "
                        f"mutated outside `with self.{lock}:` — "
                        "readers race this field")

    @staticmethod
    def _mutated_field(node, guards) -> Optional[str]:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for c in _target_chains(t):
                    if c.startswith("self.") and \
                            c[len("self."):] in guards:
                        return c[len("self."):]
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            c = attr_chain(node.func.value)
            if c and c.startswith("self.") and \
                    c[len("self."):] in guards:
                return c[len("self."):]
        return None

    @staticmethod
    def _under_lock(node, parents, lock: str) -> bool:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    c = attr_chain(item.context_expr)
                    if c == f"self.{lock}":
                        return True
            cur = parents.get(cur)
        return False


# ---------------------------------------------------------------------------
# EPOCH-GUARD

_EPOCH_GUARD_RE = re.compile(r"#\s*epoch-guard:")
_EPOCH_MUTATORS = ("write_membership", "adopt_owner_map")
_EPOCH_FIELDS = {"owner_of_shard", "shard_owner", "member_table",
                 "membership_epoch", "_membership_epoch",
                 "live_ranks", "_live_ranks"}


class EpochGuard(Rule):
    """Elastic-membership state (cluster/membership.py) moves only
    forward: epochs never regress, and every adoption of a new owner
    map must validate the advance (raise ``StaleEpochError`` on
    regression) before publishing.  Any function that rebinds
    membership state — calls :func:`write_membership` /
    ``adopt_owner_map``, or assigns an epoch/owner/live-set field —
    must carry a ``# epoch-guard: <how the advance is validated>``
    annotation on the validation line, so the invariant is stated at
    every mutation site and un-guarded writes stand out in review."""

    id = "EPOCH-GUARD"
    description = "membership state mutated without an epoch-guard note"

    def check(self, f, ctx):
        for fn in ast.walk(f.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name == "write_membership":
                continue        # the guarded choke point itself
            if fn.name == "__init__":
                continue        # pre-publication init (no epoch yet),
                # same happens-before reasoning as LOCK-GUARD
            trigger = self._trigger(fn)
            if trigger is None or self._annotated(f, fn):
                continue
            yield self.finding(
                f, trigger,
                f"function `{fn.name}` mutates elastic-membership "
                "state without a `# epoch-guard:` annotation — state "
                "how the epoch advance is validated (StaleEpochError "
                "on regression) at the mutation site")

    @staticmethod
    def _trigger(fn) -> Optional[ast.AST]:
        """First membership mutation inside ``fn``, or None."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain and chain.split(".")[-1] in _EPOCH_MUTATORS:
                    return node
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for c in _target_chains(t):
                        if c.split(".")[-1] in _EPOCH_FIELDS:
                            return node
        return None

    @staticmethod
    def _annotated(f, fn) -> bool:
        end = getattr(fn, "end_lineno", None) or len(f.lines)
        for line in f.lines[fn.lineno - 1:end]:
            if _EPOCH_GUARD_RE.search(line):
                return True
        return False


# ---------------------------------------------------------------------------
# KNOB-DOC

_CONFIG_RECEIVERS = ("config", "conf", "cfg", "_config")
_CONFIG_METHODS = ("get", "get_or", "has")


class KnobDoc(Rule):
    """Every ``[section] key`` config read must be documented in
    docs/OPERATIONS.md (the knob reference carries the default and the
    operational meaning), or, for a knob only the port reads, in the
    README's port section.  A knob that exists only in code is a knob
    operators discover during an incident."""

    id = "KNOB-DOC"
    description = ("config knob read without an OPERATIONS.md or README "
                   "port-section entry")

    def check(self, f, ctx):
        ops = ctx.operations_md
        aliases: Set[str] = set()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Attribute) and \
                    node.value.attr in _CONFIG_METHODS and \
                    self._config_receiver(node.value.value):
                for t in node.targets:
                    aliases |= _target_names(t)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) or len(node.args) < 2:
                continue
            fn = node.func
            is_knob = False
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in _CONFIG_METHODS and \
                    self._config_receiver(fn.value):
                is_knob = True
            elif isinstance(fn, ast.Name) and fn.id in aliases:
                is_knob = True
            if not is_knob:
                continue
            section = _const_str(node.args[0])
            key = _const_str(node.args[1])
            if section is None or key is None:
                continue
            if f"[{section}] {key}" not in ops:
                yield self.finding(
                    f, node,
                    f"config knob `[{section}] {key}` has no "
                    "`[section] key` entry in docs/OPERATIONS.md or the "
                    "README's port section — document it there (with its "
                    "default)")

    @staticmethod
    def _config_receiver(node) -> bool:
        c = attr_chain(node)
        if not c:
            return False
        last = c.split(".")[-1]
        return last in _CONFIG_RECEIVERS


# ---------------------------------------------------------------------------
# PLAN-DISPATCH

#: the wire-format ladder (mirrors transfer.plan.WIRE_FORMATS plus the
#: pull family's transfer.plan.PULL_FORMATS; literal so the linter
#: never imports torch).  The pull rung "bf16" is deliberately ABSENT:
#: bare "bf16" is also a dtype string and a quant-knob value, and
#: comparing a knob against it (word2vec config parsing, quant codecs)
#: is not format dispatch — "full_f32"/"sparse_q" are the distinctive
#: members that mark a pull-format branch, same reasoning as the bare
#: "psum" exclusion below.
_WIRE_FORMAT_NAMES = frozenset(
    ("dense", "sparse", "bitmap", "sparse_q", "sparse_sketch",
     "full_f32"))

#: the collective ladder (mirrors transfer.plan.COLLECTIVES minus the
#: bare "psum", which is also a collective's name and would false-
#: positive on legitimate axis-name plumbing; comparing against either
#: distinctive member of the ladder is what marks a dispatch)
_COLLECTIVE_NAMES = frozenset(("sparse_allreduce", "psum_scatter"))

#: attribute/function names whose CALL is the wire-format question
#: (push-window, hot-collective and pull families alike)
_PLAN_QUESTIONS = frozenset(
    ("decide_wire_format", "price_window_formats", "window_wire_format",
     "compile_window_plan", "price_hot_collectives", "compile_hot_plan",
     "compile_pull_plan", "price_pull_formats", "pull_route"))

#: transfer-layer modules allowed to interpret plans: the interpreter
#: itself, the plan compiler, and the codec modules its tables point at
#: (a codec IMPLEMENTS formats — encode/decode/byte-model — which is
#: the opposite of a backend dispatching on them; delta.py is the
#: row-delta codec, sketch.py the sparse_sketch codec)
#: (pull_cache.py is the delta-pull shadow — a cache keyed on row
#: versions, not a backend; it implements the hit/miss byte model the
#: pull plan prices, so it sits with the codecs)
_PLAN_INTERPRETER_FILES = frozenset(
    ("api.py", "plan.py", "sketch.py", "delta.py",
     "sparse_allreduce.py", "pull_cache.py"))


class PlanDispatch(Rule):
    """The TrafficPlan interpreter (transfer/api.py ``push_window``) is
    the ONE dispatch point of the transfer stack: backend modules are
    primitive providers and must neither ask the wire-format question
    (``decide_wire_format``/``price_window_formats``/
    ``compile_window_plan``) nor branch on a wire-format name.  A new
    format is a plan-table edit plus a codec module — the moment a
    backend compares against ``"bitmap"`` the table stops being the
    single source of truth and every future rung pays four backends
    again (the tax this rule pins out).  Collective selection
    (``"sparse_allreduce"`` vs the dense collectives) is the same
    dispatch in a different column of the plan table, so comparing
    against a collective name trips identically."""

    id = "PLAN-DISPATCH"
    description = ("wire-format branch or pricing call in a transfer "
                   "backend (belongs in the plan interpreter)")

    def check(self, f, ctx):
        rel = "/" + f.rel.replace("\\", "/")
        if "/transfer/" not in rel:
            return
        if rel.rsplit("/", 1)[-1] in _PLAN_INTERPRETER_FILES:
            return
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Compare):
                name = self._format_operand(node)
                if name is not None:
                    kind = ("collective" if name in _COLLECTIVE_NAMES
                            else "wire format")
                    yield self.finding(
                        f, node,
                        f"comparison against {kind} {name!r} in a "
                        "transfer backend — format dispatch belongs in "
                        "the TrafficPlan interpreter "
                        "(transfer/api.py); add formats via "
                        "transfer/plan.py tables")
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func) or ""
                leaf = chain.split(".")[-1]
                if leaf in _PLAN_QUESTIONS:
                    yield self.finding(
                        f, node,
                        f"`{leaf}` called from a transfer backend — "
                        "only the TrafficPlan interpreter "
                        "(transfer/api.py) asks the wire-format "
                        "question; backends receive a compiled plan")

    @staticmethod
    def _format_operand(node: ast.Compare):
        """The wire-format or collective name a comparison tests
        against, if any: catches ``x == "bitmap"``, ``x ==
        "sparse_allreduce"`` and ``x in ("dense", "sparse")``."""
        names = _WIRE_FORMAT_NAMES | _COLLECTIVE_NAMES
        for side in (node.left, *node.comparators):
            if isinstance(side, ast.Constant) and side.value in names:
                return side.value
            if isinstance(side, (ast.Tuple, ast.List, ast.Set)):
                for e in side.elts:
                    if isinstance(e, ast.Constant) and \
                            e.value in names:
                        return e.value
        return None


RULES = (ReaderPureHost(), ProducerNoRng(), ProducerNoDevice(),
         LedgerMonotonic(), TelemetryCatalog(), LockGuard(), EpochGuard(),
         KnobDoc(), PlanDispatch())
