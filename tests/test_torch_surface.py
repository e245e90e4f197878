"""The port's public surface against the JAX package's, read from the
sources with ``ast`` (neither package is imported).

Every public top-level function, class and constant of a JAX module, and
every public member of a public class (its methods, properties, class
attributes, dataclass fields and the attributes ``__init__`` sets, with
its bases followed by name), must have a counterpart at the same place in
the port: the module of the same path unless :data:`MODULES` maps it, the
class of the same name unless :data:`RENAMED` names another.  A name the
port keeps under another name or in another module stands in
:data:`RENAMED`; a name with no counterpart stands in :data:`EXCLUDED`,
with its reason (JAX-only, ROADMAP A11d, or different on purpose with its
ROADMAP line).  An exclusion whose name the port now has is stale, and so
is a rename whose target is gone.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "swiftmpi_tpu", ROOT / "swiftmpi_tpu_torch"

#: JAX module -> the port module that holds its counterparts
MODULES = {
    "transfer/xla.py": "transfer/single.py",
    "transfer/tpu.py": "transfer/sharded.py",
    "ops/pallas_kernels.py": "kernels/adagrad.py",
    "ops/pallas_gather.py": "kernels/gather.py",
    "ops/pallas_scatter.py": "kernels/scatter.py",
    "ops/pallas_stencil.py": "kernels/stencil.py",
    "ops/pallas_ring.py": "kernels/ring.py",
}

_JAX_ONLY = "JAX-only: "
_A11D = "ROADMAP A11d (shards and axes on different cards): "
_ON_PURPOSE = "different on purpose, ROADMAP "
_MESH = (_JAX_ONLY + "the name of a jax.sharding.Mesh axis or the mesh "
         "that shard_map reads; the port's ranks are a "
         "cluster.mesh.RankLayout, " + _A11D.rstrip(": "))
_DISPATCH = (_JAX_ONLY + "a Pallas dispatch helper (VMEM budget, "
             "interpret mode, method or verdict pick); the port's wrapper "
             "launches its CUDA kernel for a CUDA tensor")
_MEMBERSHIP = (_ON_PURPOSE + "A 'Not ported, each on purpose': "
               "Transfer.on_membership has only test callers in JAX; the "
               "elastic worker adopts epochs through its own sync")

#: (JAX module, dotted name) -> (port module, dotted name)
RENAMED = {
    ("ops/pallas_kernels.py", "adagrad_update"):
        ("kernels/adagrad.py", "adagrad_update_"),
    ("ops/pallas_gather.py", "vmem_gather"):
        ("kernels/gather.py", "masked_gather"),
    ("ops/pallas_gather.py", "masked_vmem_gather"):
        ("kernels/gather.py", "masked_gather"),
    ("ops/pallas_scatter.py", "vmem_scatter_add"):
        ("kernels/scatter.py", "masked_scatter_add"),
    ("ops/pallas_scatter.py", "masked_vmem_scatter_add"):
        ("kernels/scatter.py", "masked_scatter_add"),
    ("ops/pallas_stencil.py", "fused_stencil_gather"):
        ("kernels/stencil.py", "stencil_context_sum"),
    ("transfer/xla.py", "XlaTransfer"):
        ("transfer/single.py", "SingleTransfer"),
    ("transfer/tpu.py", "TpuTransfer"):
        ("transfer/sharded.py", "ShardedTransfer"),
    ("io/pipeline.py", "device_put_transfer"):
        ("io/pipeline.py", "CudaTransfer"),
}

#: (JAX module, dotted name) -> why the port has no counterpart
EXCLUDED = {
    ("utils/jax_compat.py", "*"): _JAX_ONLY + "JAX version shims",
    ("utils/xla_env.py", "*"): _JAX_ONLY + "XLA flags and libtpu set-up",
    ("analysis/rules.py", "DonateEscape"):
        _ON_PURPOSE + "C 'Torch donates no buffers, so the lint has no "
        "DONATE-ESCAPE rule'",
    ("cluster/mesh.py", "log"): _A11D + "the logger of JAX's mesh builders",
    ("cluster/mesh.py", "MeshSpec"): _A11D + "a device mesh's axis sizes",
    ("cluster/mesh.py", "build_mesh"): _A11D + "builds a jax Mesh",
    ("cluster/mesh.py", "replicated"): _A11D + "a NamedSharding",
    ("cluster/mesh.py", "row_sharded"): _A11D + "a NamedSharding",
    ("cluster/mesh.py", "batch_sharded"): _A11D + "a NamedSharding",
    ("data/distributed.py", "DistributedBatcher.mesh"): _MESH,
    ("data/distributed.py", "DistributedBatcher.axis"): _MESH,
    ("parameter/sparse_table.py", "SparseTable.axis"): _MESH,
    ("parameter/sparse_table.py", "SparseTable.row_sharding"):
        _A11D + "a NamedSharding of the rows",
    ("parameter/sparse_table.py", "SparseTable.field_sharding"):
        _A11D + "a NamedSharding of a field",
    ("parameter/sparse_table.py", "SparseTable.replicated_sharding"):
        _A11D + "a replicated NamedSharding",
    ("transfer/tpu.py", "TpuTransfer.axis"): _MESH,
    ("transfer/tpu.py", "TpuTransfer.dp_axis"): _MESH,
    ("transfer/hybrid.py", "HybridTransfer.axis"): _MESH,
    ("transfer/api.py", "PushSpec.tree_flatten"):
        _JAX_ONLY + "pytree registration",
    ("transfer/api.py", "PushSpec.tree_unflatten"):
        _JAX_ONLY + "pytree registration",
    ("transfer/api.py", "Transfer.on_membership"): _MEMBERSHIP,
    ("transfer/hybrid.py", "HybridTransfer.on_membership"): _MEMBERSHIP,
    ("transfer/local.py", "LocalTransfer.on_membership"): _MEMBERSHIP,
    ("transfer/local.py", "LocalTransfer.membership_log"): _MEMBERSHIP,
    ("transfer/tpu.py", "TpuTransfer.on_membership"): _MEMBERSHIP,
    ("transfer/xla.py", "XlaTransfer.on_membership"): _MEMBERSHIP,
    ("parameter/access.py", "PallasAdaGradAccess"):
        _ON_PURPOSE + "B (B1): the port's AdaGradAccess launches the "
        "AdaGrad kernel itself",
    ("models/logistic.py", "LogisticRegression.DENSE_CAP_LIMIT"):
        _ON_PURPOSE + "C '`dense_features: auto` stays sparse off a TPU, "
        "by JAX's rule'",
    ("ops/calibration.py", "on_tpu"): _JAX_ONLY + "asks for a TPU backend",
    ("utils/timers.py", "Throughput.device_ms"):
        _ON_PURPOSE + "G1: wall time less input stall is host time; the "
        "port's meter calls it unstalled_ms",
    ("utils/timers.py", "global_metrics"):
        _ON_PURPOSE + "G1: a process-wide Metrics that nothing in the "
        "port read, removed with the tracing nothing reads",
    ("ops/calibration.py", "INTERPRET_KIND"):
        _JAX_ONLY + "the verdict key of Pallas's interpret mode",
    ("ops/calibration.py", "record_interpret"):
        _ON_PURPOSE + "A 'Not ported, each on purpose': the port has no "
        "interpret mode",
    ("ops/calibration.py", "pallas_status"):
        _JAX_ONLY + "reports the Pallas routes' state",
    ("ops/pallas_kernels.py", "LANES"): _JAX_ONLY + "a TPU vreg's lanes",
    ("ops/pallas_kernels.py", "default_interpret"): _DISPATCH,
    ("ops/pallas_gather.py", "fits_vmem"): _DISPATCH,
    ("ops/pallas_gather.py", "use_vmem_gather"): _DISPATCH,
    ("ops/pallas_gather.py", "gather_method"): _DISPATCH,
    ("ops/pallas_gather.py", "gather_idx_block"): _DISPATCH,
    ("ops/pallas_scatter.py", "fits_vmem"): _DISPATCH,
    ("ops/pallas_scatter.py", "use_vmem_scatter"): _DISPATCH,
    ("ops/pallas_stencil.py", "fits_vmem"): _DISPATCH,
    ("ops/pallas_stencil.py", "use_fused_stencil"): _DISPATCH,
    ("ops/pallas_ring.py", "use_ring_push"): _DISPATCH,
    ("ops/pallas_ring.py", "ring_supported"): _DISPATCH,
}


def _targets(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    return []


def _package(root: Path) -> tuple:
    """``({module: {name: node}}, {class name: [ClassDef]})`` of the
    package's top-level names."""
    mods, classes = {}, {}
    for path in sorted(root.rglob("*.py")):
        rel = str(path.relative_to(root))
        top = {}
        for node in ast.parse(path.read_text()).body:
            for name in _targets(node):
                top[name] = node
        mods[rel] = top
        for name, node in top.items():
            if isinstance(node, ast.ClassDef):
                classes.setdefault(name, []).append(node)
    return mods, classes


def _members(cls: ast.ClassDef, classes: dict, seen=None) -> set:
    """The names a class defines, ``__init__``'s ``self.x`` included, and
    its bases' (followed by name through the package)."""
    seen = set() if seen is None else seen
    out = set()
    for node in cls.body:
        out.update(_targets(node))
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            for sub in ast.walk(node):
                tgts = (sub.targets if isinstance(sub, ast.Assign) else
                        [sub.target] if isinstance(sub, ast.AnnAssign)
                        else [])
                out.update(t.attr for t in tgts
                           if isinstance(t, ast.Attribute)
                           and isinstance(t.value, ast.Name)
                           and t.value.id == "self")
    for base in cls.bases:
        name = base.attr if isinstance(base, ast.Attribute) else \
            getattr(base, "id", None)
        if name in classes and name not in seen:
            seen.add(name)
            out |= _members(classes[name][0], classes, seen)
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


@pytest.fixture(scope="module")
def surfaces():
    return _package(JAX_PKG), _package(PORT_PKG)


def _diff(surfaces) -> tuple:
    """``(missing, stale, renames_gone)``: JAX names with no counterpart
    and no exclusion, exclusions the port now covers, and renames whose
    target the port lacks."""
    (jmods, jclasses), (pmods, pclasses) = surfaces
    missing, covered = [], set()

    def has(pmod: str, dotted: str) -> bool:
        top = pmods.get(pmod, {})
        name, _, member = dotted.partition(".")
        if name not in top:
            return False
        return not member or (isinstance(top[name], ast.ClassDef)
                              and member in _members(top[name], pclasses))

    for jmod, names in jmods.items():
        if (jmod, "*") in EXCLUDED:
            if MODULES.get(jmod, jmod) in pmods:
                covered.add((jmod, "*"))
            continue
        pmod_default = MODULES.get(jmod, jmod)
        for name, node in names.items():
            if not _public(name):
                continue
            entries = [name]
            # an excluded class takes its members with it
            if isinstance(node, ast.ClassDef) and \
                    (jmod, name) not in EXCLUDED:
                entries += [f"{name}.{m}" for m in
                            sorted(_members(node, jclasses)) if _public(m)]
            for dotted in entries:
                cls, _, member = dotted.partition(".")
                pmod, pname = RENAMED.get((jmod, cls), (pmod_default, cls))
                target = f"{pname}.{member}" if member else pname
                if (jmod, dotted) in EXCLUDED:
                    if has(pmod, target):
                        covered.add((jmod, dotted))
                    continue
                if not has(pmod, target):
                    missing.append(f"{jmod}: {dotted} -> {pmod}: {target}")
    gone = [f"{k} -> {v}" for k, v in RENAMED.items() if not has(*v)]
    return missing, sorted(covered), gone


def test_every_jax_name_has_a_port_counterpart(surfaces):
    missing, _, _ = _diff(surfaces)
    assert not missing, "\n".join(missing)


def test_no_exclusion_or_rename_is_stale(surfaces):
    _, stale, gone = _diff(surfaces)
    assert not stale, f"the port now has these excluded names: {stale}"
    assert not gone, f"renamed targets the port lacks: {gone}"


@pytest.mark.parametrize("key", sorted(EXCLUDED))
def test_each_exclusion_names_a_jax_name_and_a_reason(surfaces, key):
    """Every exclusion gives its kind of reason and names a public JAX
    name (or module) that exists."""
    (jmods, jclasses), _ = surfaces
    reason = EXCLUDED[key]
    assert reason.startswith((_JAX_ONLY, _A11D, _ON_PURPOSE)), reason
    jmod, dotted = key
    assert jmod in jmods, jmod
    if dotted == "*":
        return
    cls, _, member = dotted.partition(".")
    assert cls in jmods[jmod], dotted
    if member:
        assert member in _members(jmods[jmod][cls], jclasses), dotted


def test_the_walk_sees_members_bases_and_init_attributes(surfaces):
    """The walk itself: a hybrid transfer's forwarding properties, a base
    class's methods reached through the bases and ``__init__``'s
    attributes, on both sides."""
    (jmods, jclasses), (pmods, pclasses) = surfaces
    jh = _members(jmods["transfer/hybrid.py"]["HybridTransfer"], jclasses)
    ph = _members(pmods["transfer/hybrid.py"]["HybridTransfer"], pclasses)
    for name in ("metrics", "bucket_capacity", "pull", "push_window",
                 "traffic", "tail"):
        assert name in jh and name in ph, name
    st = _members(pmods["transfer/sharded.py"]["ShardedTransfer"], pclasses)
    assert {"metrics", "overflow_count", "bucket_capacity"} <= st
