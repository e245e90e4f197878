"""The port stands alone: importing it loads neither ``jax`` nor the JAX
package, its entry points refuse to fall back to the CPU silently, and
``chip_smoke.py`` fails without a CUDA device or outside the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from swiftmpi_tpu_torch.device import resolve_device
from swiftmpi_tpu_torch.models.word2vec import Word2Vec
from swiftmpi_tpu_torch.utils import ConfigParser

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import swiftmpi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    swiftmpi_tpu_torch.__path__, "swiftmpi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                    "swiftmpi_tpu"))
want = {"swiftmpi_tpu_torch." + m for m in (
    "utils.hashing", "cluster.hashfrag", "cluster.mesh", "cluster.cluster",
    "kernels.ring", "transfer.sharded", "parameter.key_index",
    "parameter.sparse_table", "models.word2vec", "apps.w2v_main",
    "utils.timers", "utils.pipeline", "data.native", "io.pipeline",
    "io.checkpoint", "io.resilience", "testing.faults", "utils.health",
    "models.sent2vec", "apps.sent2vec_main", "models.logistic",
    "data.libsvm", "apps.lr_main", "models.glove", "apps.glove_main",
    "models.embedding", "apps.w2v_eval", "utils.graphs", "apps.lr_profile",
    "apps.glove_profile", "transfer.plan", "transfer.local",
    "transfer.hybrid", "transfer.sketch", "transfer.sparse_allreduce",
    "transfer.pull_cache", "transfer.delta", "obs", "obs.identity",
    "obs.registry", "obs.catalog", "obs.micro", "obs.recorder",
    "obs.collector", "obs.numerics", "obs.costs", "obs.profiler",
    "obs.trace", "utils.profiler", "utils.buffer", "parameter.cache",
    "serve", "serve.snapshot", "serve.reader", "serve.query",
    "serve.shipper", "control", "control.sketch", "control.controller",
    "cluster.bootstrap", "launch", "parallel", "parallel.collectives",
    "data.distributed", "testing.mp_child", "cluster.membership",
    "cluster.elastic", "testing.fleet_child", "testing.serve_child",
    "utils.tree", "parallel.ring_attention", "parallel.moe",
    "parallel.pipeline", "models.transformer", "models.optim",
    "models.trainer", "ops.calibration", "utils.rng", "testing.w2v_oracle",
    "analysis", "analysis.core", "analysis.rules", "analysis.lint")}
missing = sorted(want - set(names))
print(len(names), "modules;", "leaked:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 30 else 0)
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_every_port_module_loads_no_jax():
    r = _run(["-c", _IMPORT_ALL], ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "leaked: []" in r.stdout and "missing: []" in r.stdout


#: the port's counterparts of the JAX package's READER-PURE-HOST set:
#: serving readers and the control sketch's producer side run beside the
#: trainer and never touch the device
HOST_ONLY = ("serve/reader.py", "serve/shipper.py", "parameter/cache.py",
             "control/sketch.py")


@pytest.mark.parametrize("rel", HOST_ONLY)
def test_host_only_modules_import_no_torch(rel):
    """No ``import torch`` (at module level or inside a function) and no
    ``torch.`` name in the module: the port's form of the JAX package's
    READER-PURE-HOST lint rule."""
    import ast
    tree = ast.parse((ROOT / "swiftmpi_tpu_torch" / rel).read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        elif isinstance(node, ast.Name) and node.id == "torch":
            mods = ["torch"]
        else:
            continue
        bad += [m for m in mods if m.split(".")[0] in ("torch", "jax",
                                                       "swiftmpi_tpu")]
    assert bad == [], bad


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Word2Vec(config=ConfigParser(), device=None)


def test_new_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    """With no CUDA device, logistic regression, GloVe, the embedding
    index, their CLIs and a word2vec model with ``[serve]`` and
    ``[control]`` (and the serving plane's device top-k) raise unless the
    CPU is asked for by name."""
    import numpy as np
    from swiftmpi_tpu_torch.apps import glove_main, lr_main, w2v_eval
    from swiftmpi_tpu_torch.models import (EmbeddingIndex, GloVe,
                                           LogisticRegression)
    from swiftmpi_tpu_torch.utils import reset_global_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = {"cluster": {"server_num": 1, "transfer": "xla"}}
    keys, vecs = np.arange(3, dtype=np.uint64), np.eye(3, dtype=np.float32)
    for make in (lambda d: LogisticRegression(
                     config=ConfigParser().update(conf), device=d),
                 lambda d: GloVe(config=ConfigParser().update(conf),
                                 device=d),
                 lambda d: EmbeddingIndex(keys, vecs, device=d),
                 lambda d: Word2Vec(config=ConfigParser().update(
                     {"serve": {"every": 2},
                      "control": {"control": "on"}}), device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)
        assert make("cpu").device == torch.device("cpu")
    from swiftmpi_tpu_torch.serve import SnapshotPublisher
    from swiftmpi_tpu_torch.serve.query import snapshot_topk
    snap = SnapshotPublisher().publish({"v": vecs}, keys=keys,
                                       slots=np.arange(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snapshot_topk(snap, vecs, k=2, device=True)
    assert snapshot_topk(snap, vecs, k=2, device="cpu")[0].shape == (3, 2)
    (tmp_path / "d.txt").write_text("1 1:1\n")
    (tmp_path / "e.txt").write_text("1\t1 0\n2\t0 1\n")
    (tmp_path / "c.txt").write_text("1 2 3\n")
    reset_global_config()
    try:
        for main, argv in (
                (lr_main.main, ["lr", "-mode", "train", "-dataset",
                                str(tmp_path / "d.txt")]),
                (glove_main.main, ["glove", "-data",
                                   str(tmp_path / "c.txt")]),
                (w2v_eval.main, ["eval", "-embeddings",
                                 str(tmp_path / "e.txt"), "-query", "1"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)
            assert main(argv + ["-device", "cpu"]) == 0
    finally:
        reset_global_config()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_repo(tmp_path, where):
    """No CUDA device here: the script exits non-zero and prints no
    result line, in the repository and in a directory holding only the
    script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    r = _run(["chip_smoke.py"], cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
