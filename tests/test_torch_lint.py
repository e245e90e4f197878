"""The port's lint (``swiftmpi_tpu_torch/analysis``), in the form of
``tests/test_lint.py``: each rule's fixture that must trip and its
corrected twin that must pass; the host rules the port copied
(LOCK-GUARD, EPOCH-GUARD, TELEMETRY-CATALOG, LEDGER-MONOTONIC, KNOB-DOC,
PLAN-DISPATCH) give the JAX package's findings on the same fixture; the
torch forms of READER-PURE-HOST, PRODUCER-NO-RNG and PRODUCER-NO-DEVICE;
suppression, the port's own baseline, the CLI; and the lint over the
port reports no new finding."""

import json
import textwrap

import pytest

from swiftmpi_tpu.analysis import core as jcore
from swiftmpi_tpu_torch.analysis import RULES, core
from swiftmpi_tpu_torch.analysis.lint import main as lint_main


def _write(tmp_path, rel, src, ops=None, readme=None):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    if ops is not None:
        (tmp_path / "docs").mkdir(exist_ok=True)
        (tmp_path / "docs" / "OPERATIONS.md").write_text(ops)
    if readme is not None:
        (tmp_path / "README.md").write_text(readme)
    return p


def lint_src(tmp_path, rel, src, ops=None, readme=None):
    """Lint the one file ``src`` written at ``tmp_path/rel`` (rules key
    off serve/, io/pipeline.py, transfer/); the NEW findings."""
    p = _write(tmp_path, rel, src, ops, readme)
    new, _ = core.run_lint(paths=[str(p)], root=str(tmp_path))
    return new


def rules_of(findings):
    return {f.rule for f in findings}


# -- the host rules: the JAX package's findings on the same fixture ----------

#: (name, path, source, OPERATIONS.md, the rules it must trip)
HOST_FIXTURES = [
    ("ledger_reset", "pkg/transfer/fancy.py", """
    class FancyTransfer:
        def finish_epoch(self):
            st = self._wire_state()
            st["wire_bytes"] = 0

        def reset_traffic(self):
            pass
    """, None, ["LEDGER-MONOTONIC"] * 2),
    ("ledger_increment", "pkg/transfer/fancy.py", """
    class FancyTransfer:
        def push(self, n):
            st = self._wire_state()
            st["wire_bytes"] += n
    """, None, []),
    ("ledger_hand_rolled", "pkg/bench_thing.py", """
    def measure(tr, run):
        before = tr.traffic()
        run()
        after = tr.traffic()
        return after["wire_bytes"] - before["wire_bytes"]
    """, None, ["LEDGER-MONOTONIC"]),
    ("ledger_delta", "pkg/bench_thing.py", """
    def measure(tr, run):
        before = tr.traffic()
        run()
        return tr.traffic_delta(before)
    """, None, []),
    ("telemetry_undeclared", "pkg/thing.py", """
    def record(reg, k):
        reg.counter("transfer/wire_bytez").inc(1)
        reg.gauge(f"bogus_{k}").set(1)
    """, None, ["TELEMETRY-CATALOG"] * 2),
    ("telemetry_declared", "pkg/thing.py", """
    def record(reg, knob, k):
        reg.histogram("phase_ms").observe(1.0)
        reg.gauge(f"control/{knob}").set(2)
        reg.gauge(f"micro_{k}", cell="c").set(3)
    """, None, []),
    ("telemetry_obs_inc", "pkg/transfer/fancy.py", """
    class FancyTransfer:
        def push(self):
            self._obs_inc("wire_bytes", 1)
            self._obs_inc("membership_changes", 1)
            self._obs_inc("not_a_ledger_key", 1)
    """, None, ["TELEMETRY-CATALOG"]),
    ("lock_outside", "pkg/pub.py", """
    import threading

    class Pub:
        def __init__(self):
            self._lock = threading.Lock()
            self._latest = None      # guarded-by: _lock
            self._history = []       # guarded-by: _lock

        def publish(self, snap):
            self._history.append(snap)
            self._latest = snap
    """, None, ["LOCK-GUARD"] * 2),
    ("lock_inside", "pkg/pub.py", """
    import threading

    class Pub:
        def __init__(self):
            self._lock = threading.Lock()
            self._latest = None      # guarded-by: _lock

        def publish(self, snap, other):
            with self._lock:
                self._latest = snap
            with other:
                pass
    """, None, []),
    ("epoch_unannotated", "pkg/worker.py", """
    class Worker:
        def sync(self, table):
            self.member_table = table
            self.epoch = table.epoch

    def publish(mem, fleet_dir, table):
        mem.write_membership(fleet_dir, table)
    """, None, ["EPOCH-GUARD"] * 2),
    ("epoch_annotated", "pkg/worker.py", """
    class Worker:
        _membership_epoch = -1

        def __init__(self):
            self.member_table = None

        def sync(self, table):
            if table.epoch < self.epoch:
                raise ValueError("stale epoch")
            # epoch-guard: regression raised above
            self.member_table = table

    def write_membership(dirpath, table):
        owner_of_shard = tuple(table.owner_of_shard)
        return owner_of_shard
    """, None, []),
    ("knob_missing", "pkg/mod.py", """
    def setup(config):
        return config.get_or("fancy", "speed", 3).to_int32()
    """, "# Operations\n\nnothing here\n", ["KNOB-DOC"]),
    ("knob_documented", "pkg/mod.py", """
    def setup(config, meta):
        g = config.get_or
        a = g("fancy", "speed", 3).to_int32()
        b = config.get("fancy", "mode")
        return a, b, meta.get("query_field", "vectors")
    """, "| `[fancy] speed` | 3 |\n`[fancy] mode` docs\n", []),
    ("plan_branch", "pkg/transfer/custom.py", """
    def exchange(self, state, fmt, tr):
        if fmt == "bitmap":
            return state
        if fmt in ("sparse_q", "sparse_sketch"):
            return state
        if tr.collective_mode == "sparse_allreduce":
            return state
        return tr.compile_window_plan(state)
    """, None, ["PLAN-DISPATCH"] * 4),
    ("plan_interpreter", "pkg/transfer/api.py", """
    def push_window(self, fmt, plan):
        if fmt == "bitmap":
            return plan
        return self.compile_window_plan(plan)
    """, None, []),
]


@pytest.mark.parametrize("name,rel,src,ops,want", HOST_FIXTURES,
                         ids=[f[0] for f in HOST_FIXTURES])
def test_host_rule_fixture_matches_jax(tmp_path, name, rel, src, ops,
                                       want):
    """The fixture trips (or passes) as expected, and the JAX package's
    linter gives the same rules at the same lines."""
    p = _write(tmp_path, rel, src, ops)
    new, _ = core.run_lint(paths=[str(p)], root=str(tmp_path))
    assert sorted(f.rule for f in new) == sorted(want)
    jnew, _ = jcore.run_lint(paths=[str(p)], root=str(tmp_path))
    jnew = [f for f in jnew if f.rule != "DONATE-ESCAPE"]
    assert sorted((f.rule, f.line) for f in new) == \
        sorted((f.rule, f.line) for f in jnew)


def test_knob_doc_reads_the_readme_port_section(tmp_path):
    """A knob only the port reads may be documented in the README's port
    section (and only there: the rest of the README does not count)."""
    src = """
    def setup(config):
        return config.get_or("portonly", "depth", 2).to_int32()
    """
    readme = ("# Title\n\n`[portonly] depth` outside\n\n"
              "## PyTorch/CUDA port (`swiftmpi_tpu_torch/`)\n\n"
              "nothing\n\n## Next\n")
    assert rules_of(lint_src(tmp_path, "pkg/mod.py", src, ops="",
                             readme=readme)) == {"KNOB-DOC"}
    readme = readme.replace("nothing", "`[portonly] depth` (default 2)")
    assert lint_src(tmp_path, "pkg/mod.py", src, readme=readme) == []


# -- the torch forms -----------------------------------------------------------

def test_reader_pure_host_trips_on_torch_and_cuda(tmp_path):
    new = lint_src(tmp_path, "pkg/serve/reader.py", """
    import numpy as np
    import torch

    def read(snap, keys, dev):
        rows = torch.from_numpy(snap.rows(keys))
        t = rows.cuda()
        return np.asarray(rows.to("cuda:0")), t.sum(), dev.put(device="cuda")
    """)
    assert [f.rule for f in new] == ["READER-PURE-HOST"] * 5
    msgs = " ".join(f.message for f in new)
    assert "import of `torch`" in msgs and "`torch.from_numpy`" in msgs
    assert "`.cuda()`" in msgs and '`"cuda"` device' in msgs


def test_reader_pure_host_passes_on_numpy_and_the_device_topk(tmp_path):
    new = lint_src(tmp_path, "pkg/serve/query.py", """
    import numpy as np

    def topk_host(vecs, q, k):
        return np.argsort(-(vecs @ q))[:k]

    def topk_device(vecs, q, k):  # smtpu-lint: disable=READER-PURE-HOST
        import torch
        return torch.topk(torch.from_numpy(vecs @ q), k)
    """)
    assert new == []
    # outside the serve path torch is fine
    assert lint_src(tmp_path, "pkg/models/m.py", """
    import torch

    def f(x):
        return x.cuda()
    """) == []


def test_producer_no_rng_trips_on_every_generator(tmp_path):
    new = lint_src(tmp_path, "pkg/io/pipeline.py", """
    import random
    import numpy as np
    import torch

    def produce(items, seed):
        g = torch.Generator().manual_seed(seed)
        np.random.shuffle(items)
        return torch.randperm(len(items), generator=g), random.random()
    """)
    assert [f.rule for f in new] == ["PRODUCER-NO-RNG"] * 5
    assert lint_src(tmp_path, "pkg/io/pipeline.py", """
    import torch

    def produce(items):
        return [torch.as_tensor(x) for x in items]
    """) == []
    assert lint_src(tmp_path, "pkg/models/m.py", """
    import torch

    def draw(n):
        return torch.rand(n)
    """) == []


def test_producer_no_device_trips_on_implicit_placement(tmp_path):
    new = lint_src(tmp_path, "pkg/io/pipeline.py", """
    import torch

    def produce(x):
        dev = torch.cuda.current_device()
        y = x.cuda()
        z = x.to("cuda")
        torch.set_default_device("cuda:0")
        return dev, y, z, torch.empty(3, device="cuda")
    """)
    assert sorted(f.rule for f in new) == ["PRODUCER-NO-DEVICE"] * 5


def test_producer_no_device_passes_with_the_captured_device(tmp_path):
    new = lint_src(tmp_path, "pkg/io/pipeline.py", """
    import torch

    class CudaTransfer:
        def __init__(self, device):
            self.device = torch.device(device)
            self.stream = torch.cuda.Stream(self.device)

        def __call__(self, host):
            with torch.cuda.device(self.device):
                t = host.to(self.device, non_blocking=True)
            cur = torch.cuda.current_stream(self.device)
            return t, cur, host.cuda(self.device)
    """)
    assert new == []


def test_the_rule_set():
    """Every rule of the JAX package's but DONATE-ESCAPE, which has no
    torch counterpart (torch donates no buffers)."""
    from swiftmpi_tpu.analysis.rules import RULES as JRULES
    ids = [r.id for r in RULES]
    assert ids == [r.id for r in JRULES if r.id != "DONATE-ESCAPE"]
    assert len(set(ids)) == len(ids) == 9


# -- the engine ----------------------------------------------------------------

def test_suppression_and_baseline(tmp_path):
    """A line directive, a block directive and a file directive each
    silence their rule; a baselined finding lands in the second list and
    stays gating until its justification is written."""
    src = """
    import torch

    def read(x):
        return torch.zeros(3)  # smtpu-lint: disable=READER-PURE-HOST
    """
    new = lint_src(tmp_path, "pkg/serve/reader.py", src)
    assert [f.line for f in new] == [2]         # the import only
    p = _write(tmp_path, "pkg/serve/reader.py", """
    def read(x):
        import torch
        return torch.zeros(3)
    """)
    new, old = core.run_lint(paths=[str(p)], root=str(tmp_path))
    assert len(new) == 2 and old == []
    base = str(tmp_path / "base.json")
    assert core.write_baseline(base, new) == 2
    new2, old2 = core.run_lint(paths=[str(p)], root=str(tmp_path),
                               baseline=core.load_baseline(base))
    assert len(old2) == 2
    assert rules_of(new2) == {"BASELINE-JUSTIFY"}
    data = json.loads(open(base).read())
    for e in data["findings"]:
        e["justification"] = "a reason"
    open(base, "w").write(json.dumps(data))
    new3, _ = core.run_lint(paths=[str(p)], root=str(tmp_path),
                            baseline=core.load_baseline(base))
    assert new3 == []


def test_cli_exit_codes_and_json(tmp_path, capsys):
    p = _write(tmp_path, "pkg/io/pipeline.py", """
    import random
    """)
    assert lint_main([str(p), "--root", str(tmp_path), "--format", "json",
                      "--baseline", "none"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["schema"] == "smtpu-lint/1" and out["counts"]["new"] == 1
    q = _write(tmp_path, "pkg/ok.py", "x = 1\n")
    assert lint_main([str(q), "--root", str(tmp_path)]) == 0


def test_port_is_lint_clean():
    """``python -m swiftmpi_tpu_torch.analysis.lint`` over the port and
    ``chip_smoke.py``: no new finding, and every baseline entry carries
    its reason."""
    root = core.repo_root()
    paths = core.default_paths(root)
    assert any(p.endswith("chip_smoke.py") for p in paths)
    assert all("swiftmpi_tpu_torch" in p or p.endswith("chip_smoke.py")
               for p in paths)
    baseline = core.load_baseline(f"{root}/{core.BASELINE_NAME}")
    assert all(e["justification"].strip() for e in baseline.values())
    new, old = core.run_lint(root=root, baseline=baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert len(old) == len(baseline)
