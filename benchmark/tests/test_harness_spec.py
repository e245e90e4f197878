"""The harness finds every cell's parts by name, and the manifest keeps
the contract's shape."""

import copy
import importlib
import json
import re

import pytest

from benchmark import spec
from benchmark.corpora import text8_fit

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return spec.load_json(spec.MANIFEST)


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(m)) < 64 * 1024
    assert 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0 < e["bound"] <= 0.25 and UNIT.match(e["unit"])
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert p["moves"] in e2e and UNIT.match(p["unit"])
        assert NAME.match(p["name"])


@pytest.mark.parametrize("name", [w["name"] for w in manifest()["workloads"]])
def test_cell_parts_found_by_name(name):
    cell = spec.load_cell(name)
    for key in ("len_vec", "window", "negative", "sample", "corpus", "sg"):
        assert key in cell.config
    for key in ("batch_centers", "inner_steps", "pipeline", "transfer"):
        assert key in cell.traffic
    assert {"loss_gap", "grad_norm_gap", "update_norm_gap"} <= set(
        cell.limits)
    assert cell.per_layer, "every cell reports a per-layer metric"
    for p in cell.per_layer:
        assert callable(spec.metric_reader(p["name"]))
    assert {e["name"] for e in cell.end_to_end} >= {"setup_s",
                                                    "words_per_s"}
    # the model, corpus, feed and table modules, each by its key's name
    model = spec.model_module(cell)
    assert callable(model.Program) and callable(model.readings)
    for pkg, key in (("corpora", cell.config["corpus"]),
                     ("feeds", cell.traffic["batcher"]),
                     ("tables", cell.traffic["transfer"])):
        assert importlib.import_module(f"benchmark.{pkg}.{key}")


def test_a_metric_reaches_only_the_cells_it_names():
    m = copy.deepcopy(manifest())
    m["end_to_end"].append({"name": "examples_per_s", "unit": "1/s",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["some_other_cell"]})
    # without ``workloads``: every cell that reports what it moves
    m["per_layer"].append({"name": "anywhere_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "dispatch", "moves": "words_per_s"})
    m["per_layer"].append({"name": "elsewhere_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "dispatch", "moves": "examples_per_s"})
    for w in m["workloads"]:
        cell = spec.load_cell(w["name"], m)
        assert "examples_per_s" not in {e["name"] for e in cell.end_to_end}
        names = {p["name"] for p in cell.per_layer}
        assert "anywhere_ms" in names and "elsewhere_ms" not in names


def test_text8_fit_holds_the_published_figures():
    cfg = spec.load_cell("w2v_cbow_text8.xla").config
    c = text8_fit.word_counts(cfg)
    assert len(c) == cfg["distinct_words"]
    assert int(c.sum()) == cfg["corpus_tokens"]
    assert int(c[0]) == cfg["top_count"] and (c[:-1] >= c[1:]).all()
    assert int((c >= cfg["min_count"]).sum()) == cfg["words_at_min_count"]
    rank, tokens = cfg["tokens_past_rank"]
    assert abs(int(c[rank:].sum()) - tokens) < 1e-3 * tokens


def test_text8_fit_draws_only_the_order():
    cfg = dict(corpus_tokens=60000, distinct_words=6000, top_count=4000,
               min_count=5, words_at_min_count=1500, knee_rank=100,
               sentence_length=200)
    a, b = text8_fit.make(cfg, 1), text8_fit.make(cfg, 2**40 + 1)
    assert (a[2] == b[2]).all() and (a[3] == b[3]).all()
    assert (a[1] == b[1]).all() and not (a[0] == b[0]).all()
    assert (a[0].max() < len(a[2])) and (
        __import__("numpy").bincount(a[0], minlength=len(a[2]))
        == a[3]).all()


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")


def test_reader_returns_none_without_a_trace():
    for p in manifest()["per_layer"]:
        assert spec.metric_reader(p["name"])({"peaks": None}) is None
