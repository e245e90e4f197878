"""The result line's keys, the check printed last, and the whole-name
look for JAX in ``sys.modules``."""

import io
import json

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [0, 1])
def test_last_line_has_the_contract_keys(traced):
    cell = tiny("w2v_cbow_text8.xla")
    result = harness.run_cell(None, 2**31 + 5, 0.5, bool(traced),
                              device="cpu", cell=cell, log=lambda *a: None)
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == REQUIRED and keys[-1] == "check"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "info", "check"}
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = set(line["metrics"])
    if traced:
        assert "input_stall_ms" in names and "words_per_s" not in names
    else:
        assert names == {"words_per_s", "peak_device_gib", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    last = err.getvalue().strip().splitlines()[-len(line["check"]):]
    assert all(s.startswith("check ") and " limit " in s for s in last)


def test_forbidden_modules_by_whole_top_level_name():
    planted = {"swiftmpi_tpu.models.word2vec": None, "numpy": None}
    assert harness.forbidden_modules(planted) == ["swiftmpi_tpu"]
    port = {"swiftmpi_tpu_torch": None, "swiftmpi_tpu_torch.models": None,
            "jaxtyping": None}
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules({"jax.numpy": None}) == ["jax"]


def test_the_run_loads_no_jax():
    assert harness.forbidden_modules() == []
