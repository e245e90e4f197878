"""The port's word2vec CLI (swiftmpi_tpu_torch.apps.w2v_main) and its
config / command-line layer, on the CPU (``-device cpu``)."""

import numpy as np
import pytest

from swiftmpi_tpu.utils import CMDLine as JaxCMDLine
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu_torch.apps import w2v_main
from swiftmpi_tpu_torch.data.text import (build_vocab, load_corpus,
                                          synthetic_corpus, write_tokens_file)
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
    ("stencil: 1\n[cluster]\ndata_plane: pallas", "stencil")])
def test_cli_trains_stencil_and_shared_confs(files, monkeypatch, lines,
                                             rendering):
    """A conf with ``stencil: 1`` and/or ``shared_negatives: 1`` trains
    through the CLI in that rendering and dumps every vocab key."""
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


@pytest.mark.parametrize("line", ["[worker]\npipeline: 2", "sg: 1",
                                  "local_steps: 4",
                                  "[cluster]\npush_window: 4",
                                  "[obs]\ntrace: 1"])
def test_cli_refuses_unported_conf_keys(files, line):
    tmp, conf, data = files
    with open(conf, "a") as f:
        f.write(line + "\n")
    with pytest.raises(NotImplementedError, match="not ported"):
        w2v_main.main(["w2v", "-config", conf, "-data", data,
                       "-device", "cpu"])


@pytest.mark.parametrize("flags", [["-variant", "async"],
                                   ["-variant", "hogwild"],
                                   ["-checkpoint", "ck"]])
def test_cli_refuses_unported_flags(files, flags):
    _, conf, data = files
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w2v_main.main(["w2v", "-config", conf, "-data", data,
                       "-device", "cpu", *flags])


def test_cli_without_device_needs_cuda(files, monkeypatch):
    """No ``-device``: the CUDA device or an error, never a silent CPU
    run."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, conf, data = files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w2v_main.main(["w2v", "-config", conf, "-data", data])


def test_cli_help_exits_cleanly(capsys):
    assert w2v_main.main(["w2v", "-help"]) == 0
    assert "-device" in capsys.readouterr().out
