"""The port's word2vec CLI (swiftmpi_tpu_torch.apps.w2v_main) and its
config / command-line layer, on the CPU (``-device cpu``)."""

import numpy as np
import pytest

from swiftmpi_tpu.utils import CMDLine as JaxCMDLine
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps import w2v_main
from swiftmpi_tpu_torch.data.text import (bkdr_hash, build_vocab,
                                          load_corpus, synthetic_corpus,
                                          tokenize, write_tokens_file)
from swiftmpi_tpu_torch.models.word2vec import w2v_parser
from swiftmpi_tpu_torch.utils import (CMDLine, ConfigParser, global_config,
                                      reset_global_config)

DEMO = ("# demo.conf layout\n"
        "[cluster]\n"
        "server_num: 1\n"
        "transfer: xla\n"
        "to_split_worker_server: 0\n"
        "[worker]\n"
        "minibatch: 256\n"
        "[server]\n"
        "frag_num: 2000\n"
        "shard_num: 20\n"
        "initial_learning_rate: 0.3\n"
        "[word2vec]\n"
        "len_vec: 8  # trailing comment\n"
        "window 2\n"
        "negative: 3\n"
        "sample: 0.001\n"
        "learning_rate: 0.05\n")


@pytest.fixture(autouse=True)
def _fresh_port_config():
    reset_global_config()
    yield
    reset_global_config()


@pytest.fixture
def files(tmp_path):
    conf = tmp_path / "demo.conf"
    conf.write_text(DEMO)
    data = tmp_path / "corpus.txt"
    write_tokens_file(synthetic_corpus(40, 60, 12, seed=1), str(data))
    return tmp_path, str(conf), str(data)


def test_config_and_cmdline_parse_like_jax(files):
    tmp, conf, _ = files
    (tmp / "inc.conf").write_text("import demo.conf\nextra: 5\n")
    for path in (conf, str(tmp / "inc.conf")):
        assert ConfigParser(path).as_dict() == JaxConfig(path).as_dict()
    argv = ["prog", "-config", conf, "-niters", "3", "-alpha", "-0.5",
            "-flag"]
    a, b = CMDLine(argv), JaxCMDLine(argv)
    assert a.keys() == b.keys()
    for k in a.keys():
        assert a.getValue(k) == b.getValue(k)


def test_cli_trains_and_writes_a_dump_that_parses(files):
    tmp, conf, data = files
    out = tmp / "vectors.txt"
    rc = w2v_main.main(["w2v", "-config", conf, "-data", data, "-niters",
                        "2", "-output", str(out), "-device", "cpu"])
    assert rc == 0
    assert global_config().get("word2vec", "len_vec").to_int32() == 8
    vocab = build_vocab(load_corpus(data))
    lines = out.read_text().splitlines()
    assert len(lines) == len(vocab)
    keys = set()
    for line in lines:
        key, _, rest = line.partition("\t")
        row = w2v_parser(rest)
        assert row["v"].shape == row["h"].shape == (8,)
        assert np.isfinite(row["v"]).all() and np.isfinite(row["h"]).all()
        keys.add(int(key))
    assert keys == set(vocab.keys.tolist())


@pytest.mark.parametrize("lines,rendering", [
    ("stencil: 1", "stencil"), ("shared_negatives: 1", "shared"),
    ("stencil: 1\nshared_negatives: 1\nshared_pool: 32", "stencil_shared"),
    ("stencil: 1\n[cluster]\ndata_plane: pallas", "stencil"),
    ("sg: 1", "sg"), ("sg: 1\nshared_negatives: 1\nshared_pool: 32",
                      "sg_shared"),
    ("dense_logits: 1", "dense"), ("local_steps: 4", "gather")])
def test_cli_trains_stencil_and_shared_confs(files, monkeypatch, lines,
                                             rendering):
    """A conf with ``stencil: 1``, ``shared_negatives: 1``, ``sg: 1``,
    ``dense_logits: 1`` or ``local_steps`` trains through the CLI in that
    rendering and dumps every vocab key."""
    tmp, conf, data = files
    with open(conf, "a") as f:
        f.write(lines + "\n")
    seen = []
    train = w2v_main.Word2Vec.train

    def spy(self, *a, **k):
        out = train(self, *a, **k)
        seen.append((self.resolved_rendering, out))
        return out

    monkeypatch.setattr(w2v_main.Word2Vec, "train", spy)
    out = tmp / "vectors.txt"
    assert w2v_main.main(["w2v", "-config", conf, "-data", data, "-niters",
                          "2", "-output", str(out), "-device", "cpu"]) == 0
    assert seen[0][0] == rendering and np.isfinite(seen[0][1]).all()
    rows = [w2v_parser(line.partition("\t")[2])
            for line in out.read_text().splitlines()]
    assert len(rows) == len(build_vocab(load_corpus(data)))
    assert all(r["v"].shape == r["h"].shape == (8,) for r in rows)


@pytest.mark.parametrize("line", ["[cluster]\nserver_num: 2",
                                  "[control]\ncontrol: on",
                                  "[serve]\nevery: 4",
                                  "[cluster]\ntransfer: tpu\nserver_num: 2"
                                  "\ndata_plane: xla",
                                  "[control]\nevery: 8"])
def test_cli_refuses_unported_conf_keys(files, line):
    """What the CLI once refused now trains and writes the dump:
    ``server_num > 1`` on ``xla`` (until ROADMAP A11a was ported),
    ``[control]`` and ``[serve]`` (until A13a), ``data_plane: xla`` on
    ``tpu`` (until A16b: the library exchange)."""
    tmp, conf, data = files
    with open(conf, "a") as f:
        f.write(line + "\n")
    argv = ["w2v", "-config", conf, "-data", data, "-device", "cpu"]
    out = tmp / "vectors.txt"
    assert w2v_main.main(argv + ["-output", str(out)]) == 0
    assert out.stat().st_size > 0


@pytest.mark.parametrize("flags", [["-checkpoint", "ck"]])
def test_cli_refuses_unported_flags(files, flags):
    """The CLI refuses no flag the JAX package's ``w2v_main`` takes: every
    one of its flags is registered, and ``-checkpoint`` (the last one
    ported) trains."""
    from swiftmpi_tpu.apps import w2v_main as jax_w2v_main
    tmp, conf, data = files
    registered = []

    class Spy(CMDLine):
        def __init__(self, argv=None):
            super().__init__(argv)
            registered.append(set())

        def registerParameter(self, key, text):
            registered[-1].add(key)
            return super().registerParameter(key, text)

    for mod in (w2v_main, jax_w2v_main):
        orig = mod.CMDLine
        mod.CMDLine = Spy
        try:
            mod.main(["w2v", "-help"])
        finally:
            mod.CMDLine = orig
    port, jax_flags = registered
    assert jax_flags <= port, jax_flags - port
    flags = [flags[0], str(tmp / flags[1])]
    assert w2v_main.main(["w2v", "-config", conf, "-data", data,
                          "-device", "cpu", *flags]) == 0


def test_cli_checkpoint_crash_then_rerun_completes(files, monkeypatch):
    """``-checkpoint`` with a crash injected through ``SMTPU_FAULT_PLAN``
    (at the top of iteration 1, every time): the in-process restarts
    exhaust their budget and the command fails with the checkpoint of
    iteration 1 on disk; the same command rerun without the plan resumes
    there, trains the other two iterations and writes one row per word.
    A third run finds the checkpoint complete, trains nothing and still
    writes ``-output``."""
    from swiftmpi_tpu_torch.testing import faults
    tmp, conf, data = files
    ck, out = str(tmp / "ck"), tmp / "vectors.txt"
    argv = ["w2v", "-config", conf, "-data", data, "-niters", "3",
            "-checkpoint", ck, "-output", str(out), "-device", "cpu"]
    calls = []
    train = w2v_main.Word2Vec.train

    def spy(self, *a, **k):
        calls.append((k["start_iter"], k["niters"]))
        return train(self, *a, **k)

    monkeypatch.setattr(w2v_main.Word2Vec, "train", spy)
    monkeypatch.setenv(faults.ENV_FAULT_PLAN, faults.FaultPlan().crash_at_step(
        1, times=100).to_json())
    faults.clear()
    try:
        with pytest.raises(faults.InjectedFault):
            w2v_main.main(argv)
        assert calls == [(0, 3), (1, 2), (1, 2)] and not out.exists()
        with np.load(ck + ".npz") as z:
            assert int(z["extra__iter"]) == 1
        monkeypatch.delenv(faults.ENV_FAULT_PLAN)
        faults.clear()
        calls.clear()
        assert w2v_main.main(argv) == 0
        assert calls == [(1, 2)]
        with np.load(ck + ".npz") as z:
            assert int(z["extra__iter"]) == 3
        vocab = build_vocab(load_corpus(data))
        first = out.read_text()
        assert len(first.splitlines()) == len(vocab)
        out.unlink()
        calls.clear()
        assert w2v_main.main(argv) == 0
        assert calls == [] and out.read_text() == first
    finally:
        faults.clear()


@pytest.mark.parametrize("variant,key,val", [
    ("async", "local_steps", 4), ("hogwild", "async_mode", "hogwild")])
@pytest.mark.parametrize("loader", ["native", "python"])
def test_cli_variants_train_with_bkdr_keys(files, monkeypatch, variant, key,
                                           val, loader):
    """``-variant async`` (``local_steps: 4``) and ``-variant hogwild``
    (``async_mode: hogwild``) train on the CPU and dump one row per word,
    keyed by the BKDR hash of the word (the reference's ``w2v.cpp``
    keys), through the native loader and through ``load_corpus``."""
    from swiftmpi_tpu_torch.data import native
    tmp, conf, _ = files
    data = tmp / "words.txt"
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(40)] + ["17", "-3"]
    data.write_text("\n".join(" ".join(rng.choice(words, 12))
                              for _ in range(60)) + "\n")
    if loader == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the native loader does not build here")
    seen = []
    train = w2v_main.Word2Vec.train

    def spy(self, *a, **k):
        out = train(self, *a, **k)
        seen.append((self, out))
        return out

    monkeypatch.setattr(w2v_main.Word2Vec, "train", spy)
    out = tmp / "vectors.txt"
    assert w2v_main.main(["w2v", "-config", conf, "-data", str(data),
                          "-niters", "2", "-output", str(out), "-device",
                          "cpu", "-variant", variant]) == 0
    model, losses = seen[0]
    assert np.isfinite(losses).all()
    assert global_config().get("word2vec", key).to_string() == str(val)
    assert model.train_metrics["loader"] == loader
    assert model.train_metrics["steps"] > 0
    want = build_vocab(load_corpus(str(data), mode="bkdr"))
    assert set(want.keys.tolist()) == {bkdr_hash(w) for w in words}
    lines = out.read_text().splitlines()
    assert len(lines) == len(want)
    keys = set()
    for line in lines:
        k, _, rest = line.partition("\t")
        row = w2v_parser(rest)
        assert row["v"].shape == row["h"].shape == (8,)
        assert np.isfinite(row["v"]).all() and np.isfinite(row["h"]).all()
        keys.add(int(k))
    assert keys == set(want.keys.tolist())


def test_cli_unknown_variant_returns_1(files):
    _, conf, data = files
    assert w2v_main.main(["w2v", "-config", conf, "-data", data,
                          "-device", "cpu", "-variant", "bogus"]) == 1


def test_tokenize_and_load_corpus_bkdr_match_jax(tmp_path):
    """``mode="bkdr"`` hashes every word, integers too; ``int`` keeps
    atoi with the hash for other words; an unknown mode raises — as the
    JAX package's ``tokenize`` and ``load_corpus`` do."""
    from swiftmpi_tpu.data.text import load_corpus as jax_load_corpus
    from swiftmpi_tpu.data.text import tokenize as jax_tokenize
    line = "the 12 quick -4 brown fox \u00e9t\u00e9 the 12"
    for mode in ("int", "bkdr"):
        assert tokenize(line, mode) == jax_tokenize(line, mode)
    assert tokenize("12", "bkdr") == [bkdr_hash("12")] != tokenize("12")
    with pytest.raises(ValueError, match="mode"):
        tokenize(line, "utf8")
    path = tmp_path / "c.txt"
    path.write_text(line + "\n" + " ".join(["x"] * 2500) + "\n\nshort\n",
                    encoding="utf-8")
    for mode in ("int", "bkdr"):
        for msl in (1, 2):
            assert load_corpus(str(path), mode=mode,
                               min_sentence_length=msl) == jax_load_corpus(
                str(path), mode=mode, min_sentence_length=msl)
    with pytest.raises(ValueError, match="mode"):
        load_corpus(str(path), mode="utf8")


def test_cli_without_device_needs_cuda(files, monkeypatch):
    """No ``-device``: the CUDA device or an error, never a silent CPU
    run."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, conf, data = files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w2v_main.main(["w2v", "-config", conf, "-data", data])


@pytest.mark.parametrize("variant", ["async", "hogwild"])
def test_cli_variants_without_device_need_cuda(files, monkeypatch, variant):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, conf, data = files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w2v_main.main(["w2v", "-config", conf, "-data", data, "-variant",
                       variant])


def test_cli_help_exits_cleanly(capsys):
    assert w2v_main.main(["w2v", "-help"]) == 0
    assert "-device" in capsys.readouterr().out
