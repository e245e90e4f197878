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
             if m.split(".")[0] in ("jax", "jaxlib", "swiftmpi_tpu"))
want = {"swiftmpi_tpu_torch." + m for m in (
    "utils.hashing", "cluster.hashfrag", "cluster.mesh", "cluster.cluster",
    "kernels.ring", "transfer.sharded", "parameter.key_index",
    "parameter.sparse_table", "models.word2vec", "apps.w2v_main")}
missing = sorted(want - set(names))
print(len(names), "modules;", "leaked:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 26 else 0)
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_every_port_module_loads_no_jax():
    r = _run(["-c", _IMPORT_ALL], ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "leaked: []" in r.stdout and "missing: []" in r.stdout


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
