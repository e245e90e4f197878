"""The port's input and dispatch path against the JAX package's:
``io/pipeline.py`` (``PrefetchIterator``, case for case with
``tests/test_input_pipeline.py``, run on both implementations),
``utils/pipeline.py`` (``resolve_dispatch_bound``), ``utils/timers.py``,
``_LossAccum``, and the determinism contract of ``[worker] pipeline: K``
and ``inner_steps: N`` on the CPU: the same batches in the same order and
the same draws, so dumps are byte-identical and losses equal, in the
gather and stencil renderings, epoch tails included.  A port run against
a JAX run on the same native batcher is held to the bands of
``tests/test_w2v_oracle.py::test_loss_parity_vs_reference_oracle`` (the
two draw different negatives and start from different tables).  The
pushes and steps read nothing back to the host: they run with the
tensor-to-host conversions patched to raise.
"""

import time

import numpy as np
import pytest
import torch

from swiftmpi_tpu.data import native as jnative
from swiftmpi_tpu.io import pipeline as jax_io_pipeline
from swiftmpi_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from swiftmpi_tpu.utils import ConfigParser as JaxConfig
from swiftmpi_tpu.utils import pipeline as jax_utils_pipeline
from swiftmpi_tpu_torch.apps import w2v_main
from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, synthetic_corpus,
                                          write_tokens_file)
from swiftmpi_tpu_torch.io import pipeline as io_pipeline
from swiftmpi_tpu_torch.models.word2vec import Word2Vec, _LossAccum
from swiftmpi_tpu_torch.parameter.access import w2v_access
from swiftmpi_tpu_torch.transfer import SingleTransfer
from swiftmpi_tpu_torch.utils import ConfigParser, reset_global_config
from swiftmpi_tpu_torch.utils import pipeline as utils_pipeline
from swiftmpi_tpu_torch.utils.timers import Throughput

IMPLS = {"port": io_pipeline, "jax": jax_io_pipeline}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


# ---------------------------------------------------------------------------
# PrefetchIterator semantics, on the port's and on JAX's
# ---------------------------------------------------------------------------

def test_order_preserved(impl):
    assert list(impl.PrefetchIterator(range(100), depth=4)) \
        == list(range(100))


def test_end_of_stream_with_full_queue_drops_nothing(impl):
    """The end-of-stream sentinel never displaces an unconsumed item: the
    producer exhausts its source and blocks on the sentinel while the
    queue is still full, then every item arrives."""
    pipe = impl.PrefetchIterator([0, 1, 2], depth=3)
    deadline = time.monotonic() + 5.0
    while pipe.stats()["produced"] < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)
    assert list(pipe) == [0, 1, 2]


def test_transfer_applied_on_producer_in_order(impl):
    pipe = impl.PrefetchIterator(range(10), depth=2,
                                 transfer=lambda x: x * 2)
    assert list(pipe) == [2 * i for i in range(10)]
    assert pipe.stats()["transfer_s"] >= 0.0


def test_producer_error_after_queued_items(impl):
    def src():
        yield 1
        yield 2
        raise RuntimeError("boom")

    pipe = impl.PrefetchIterator(src(), depth=4)
    got = [next(pipe), next(pipe)]
    with pytest.raises(impl.PipelineError) as ei:
        next(pipe)
    assert got == [1, 2]
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "boom" in str(ei.value.__cause__)


def test_close_unblocks_and_joins_producer(impl):
    def infinite():
        i = 0
        while True:
            yield i
            i += 1

    pipe = impl.PrefetchIterator(infinite(), depth=1)
    assert next(pipe) == 0
    pipe.close()
    assert not pipe._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pipe)


def test_close_is_idempotent(impl):
    pipe = impl.PrefetchIterator([1], depth=1)
    assert list(pipe) == [1]
    pipe.close()
    pipe.close()


def test_context_manager_closes(impl):
    with impl.PrefetchIterator(range(100), depth=2) as pipe:
        assert next(pipe) == 0
    assert not pipe._thread.is_alive()


def test_depth_validation(impl):
    with pytest.raises(ValueError):
        impl.PrefetchIterator([1], depth=0)


def test_stats_counts(impl):
    pipe = impl.PrefetchIterator(range(7), depth=2)
    out = list(pipe)
    s = pipe.stats()
    assert out == list(range(7))
    assert s["produced"] == s["consumed"] == 7
    assert 1 <= s["peak_queue_depth"] <= 2
    assert s["stall_s"] >= 0.0
    assert s["depth"] == 2


def test_map_leaves_keeps_structure():
    item = ("group", (np.arange(6, dtype=np.int32).reshape(2, 3),
                      np.ones(4, bool)), [3, 5])
    out = io_pipeline._map_leaves(item, lambda a: a.shape)
    assert out == ("group", ((2, 3), (4,)), [3, 5])


# ---------------------------------------------------------------------------
# dispatch bound, loss accumulator, stall meter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", ["auto", None, 0, 3, "4"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_resolve_dispatch_bound_matches_jax(depth, pipelined):
    assert utils_pipeline.resolve_dispatch_bound(depth, pipelined) \
        == jax_utils_pipeline.resolve_dispatch_bound(depth, pipelined)
    assert utils_pipeline.AUTO_BOUND == jax_utils_pipeline.AUTO_BOUND


@pytest.mark.parametrize("bound", ["auto", None, 1, 16])
def test_dispatch_window_holds_nothing_on_the_cpu(bound):
    win = utils_pipeline.DispatchWindow(bound, torch.device("cpu"))
    for _ in range(40):
        win.push()
    assert len(win) == 0


def test_loss_accum_retention_bound():
    """An epoch of 10k steps retains at most ``fold`` scalars."""
    acc = _LossAccum(bound=None, device=torch.device("cpu"), fold=64)
    for _ in range(10_000):
        acc.add(torch.tensor(0.001))
    assert acc.peak_queued <= 64
    assert acc.total() == pytest.approx(10.0, rel=1e-3)


def test_loss_accum_sums_counts_in_float32():
    acc = _LossAccum(bound=None, device=torch.device("cpu"))
    for _ in range(300):
        acc.add(torch.tensor(7, dtype=torch.int64))
    assert acc.total() == 2100.0
    assert acc.peak_queued == 256


def test_loss_accum_fold_validation():
    with pytest.raises(ValueError):
        _LossAccum(bound=None, fold=1)


def test_throughput_stall_split():
    m = Throughput()
    m.record(100, steps=2)
    m.record(50)
    m.add_stall(0.05)
    with m.stalling():
        time.sleep(0.02)
    assert m.host_stall_ms() >= 60.0
    assert m.stall_ms_per_step() == pytest.approx(m.host_stall_ms() / 3)
    assert m.unstalled_ms() >= 0.0
    s = m.stats()
    assert set(s) == {"items", "steps", "rate", "host_stall_ms",
                      "unstalled_ms", "stall_ms_per_step"}
    assert s["items"] == 150.0 and s["steps"] == 3.0
    m.reset()
    assert m.host_stall_ms() == 0.0 and m.stall_ms_per_step() == 0.0


# ---------------------------------------------------------------------------
# the determinism contract on the CPU
# ---------------------------------------------------------------------------

CONF = {
    "cluster": {"server_num": 1, "transfer": "xla"},
    "word2vec": {"len_vec": 16, "window": 2, "negative": 5, "sample": 1e-3,
                 "learning_rate": 0.05, "min_sentence_length": 2},
    "server": {"initial_learning_rate": 0.3},
    "worker": {"minibatch": 512},
}
BATCH = 60


def _conf(stencil=0, **worker):
    c = ConfigParser().update(CONF)
    c.set("word2vec", "stencil", stencil)
    for k, v in worker.items():
        c.set("worker", k, v)
    return c


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipe") / "corpus.txt"
    write_tokens_file(synthetic_corpus(120, 90, 14, seed=12), str(path))
    return str(path)


def _batcher(loader, corpus_file, model):
    if loader == "native":
        vocab, tokens, offsets = native.load_corpus_native(
            corpus_file, min_sentence_length=2)
        return native.PrefetchingCBOWBatcher(tokens, offsets, vocab,
                                             model.window, model.sample)
    from swiftmpi_tpu_torch.data.text import load_corpus
    sents = load_corpus(corpus_file, min_sentence_length=2)
    model.build(sents)
    return CBOWBatcher(sents, model.vocab, model.window, model.sample,
                       seed=2008)


def _train(tmp_path, corpus_file, loader, stencil, tag, niters=2, **worker):
    model = Word2Vec(config=_conf(stencil, **worker), device="cpu", seed=5)
    batcher = _batcher(loader, corpus_file, model)
    losses = model.train(batcher=batcher, niters=niters, batch_size=BATCH)
    out = tmp_path / f"{tag}.txt"
    model.save(str(out))
    return losses, out.read_bytes(), model


@pytest.mark.parametrize("loader", ["python", "native"])
@pytest.mark.parametrize("stencil", [0, 1])
@pytest.mark.parametrize("knob", [{"pipeline": 3}, {"inner_steps": 4},
                                  {"pipeline": 2, "inner_steps": 4}])
def test_pipeline_and_inner_steps_bit_identical(tmp_path, corpus_file, loader,
                                                stencil, knob):
    ref_l, ref_dump, ref_m = _train(tmp_path, corpus_file, loader, stencil,
                                    "off")
    got_l, got_dump, got_m = _train(tmp_path, corpus_file, loader, stencil,
                                    "on", **knob)
    assert got_l == ref_l
    assert got_dump == ref_dump
    a, b = ref_m.train_metrics, got_m.train_metrics
    assert (a["steps"], a["words"]) == (b["steps"], b["words"])
    assert a["loader"] == b["loader"] == loader
    assert b["fused"] is False and b["graph_replays"] == 0   # the CPU
    assert b["pipeline_depth"] == knob.get("pipeline", 0)
    if "pipeline" in knob:
        pipe = b["pipeline"]
        assert pipe["produced"] == pipe["consumed"] > 0
        assert pipe["peak_queue_depth"] >= 1
    else:
        assert "pipeline" not in b
    for m in (a, b):
        assert m["host_stall_ms"] >= 0.0 and m["unstalled_ms"] >= 0.0
        assert m["stall_ms_per_step"] >= 0.0


@pytest.mark.parametrize("loader", ["python", "native"])
@pytest.mark.parametrize("stencil", [0, 1])
def test_epoch_has_a_partial_group(corpus_file, loader, stencil):
    """The corpus above ends every epoch with a partial group of
    ``inner_steps: 4``: the tail the determinism test covers.  Both
    batchers pad their last batch to the full shape, so it groups too."""
    model = Word2Vec(config=_conf(stencil, inner_steps=4), device="cpu")
    batcher = _batcher(loader, corpus_file, model)
    if model.vocab is None:
        model.build_from_vocab(batcher.vocab)
    items = list(model._epoch_items(batcher, BATCH, bool(stencil), True))
    groups = [len(i[2]) for i in items if i[0] == "group"]
    assert groups and groups[-1] < 4 and set(groups[:-1]) == {4}
    assert all(i[0] == "group" for i in items)


def test_cli_pipeline_inner_steps_native_bit_identical(tmp_path, corpus_file,
                                                       monkeypatch):
    """``w2v_main`` picks the native loader (g++ builds it here) and
    trains with ``pipeline: 2`` and ``inner_steps: 4`` to the same dump as
    without them."""
    seen = []

    class Recording(Word2Vec):
        def train(self, *a, **kw):
            out = super().train(*a, **kw)
            seen.append(self.train_metrics)
            return out

    monkeypatch.setattr(w2v_main, "Word2Vec", Recording)
    dumps = []
    for extra in ("", "pipeline: 2\ninner_steps: 4\n"):
        conf, out = tmp_path / "w.conf", tmp_path / f"v{len(dumps)}.txt"
        conf.write_text("[cluster]\nserver_num: 1\ntransfer: xla\n"
                        "[worker]\nminibatch: 384\n" + extra +
                        "[server]\ninitial_learning_rate: 0.3\n"
                        "[word2vec]\nlen_vec: 8\nwindow: 2\nnegative: 4\n"
                        "sample: 0.001\nlearning_rate: 0.05\n")
        reset_global_config()
        assert w2v_main.main(["w2v", "-config", str(conf), "-data",
                              corpus_file, "-niters", "2", "-output",
                              str(out), "-device", "cpu"]) == 0
        dumps.append(out.read_bytes())
    reset_global_config()
    assert dumps[0] == dumps[1]
    assert [m["loader"] for m in seen] == ["native", "native"]
    assert seen[1]["pipeline_depth"] == 2 and seen[1]["inner_steps"] == 4


# ---------------------------------------------------------------------------
# the port against JAX on the same native batcher, pipelined
# ---------------------------------------------------------------------------

def test_loss_trajectory_vs_jax_on_the_native_batcher(corpus_file):
    """Both train 4 epochs with ``pipeline: 2`` on batches from one C++
    batcher (same seed: the same batches); different RNG streams and
    initial tables, identical math otherwise.  Held as
    ``test_loss_parity_vs_reference_oracle`` holds its trajectory: both
    fall, the final losses within 12.5% relative, every epoch after the
    first within 25%."""
    shared = {"cluster": {"server_num": 1, "transfer": "xla"},
              "word2vec": {"len_vec": 16, "window": 2, "negative": 5,
                           "sample": -1, "learning_rate": 0.05,
                           "min_sentence_length": 2},
              "server": {"initial_learning_rate": 0.3},
              "worker": {"minibatch": 512, "pipeline": 2}}
    jv, jt, jo = jnative.load_corpus_native(corpus_file,
                                            min_sentence_length=2)
    jm = JaxWord2Vec(config=JaxConfig().update(shared))
    jm.build_from_vocab(jv)
    want = jm.train(niters=4, batch_size=64, batcher=jnative.NativeCBOWBatcher(
        jt, jo, jv, jm.window, jm.sample))
    pv, pt, po = native.load_corpus_native(corpus_file,
                                           min_sentence_length=2)
    pm = Word2Vec(config=ConfigParser().update(shared), device="cpu")
    got = pm.train(niters=4, batch_size=64, batcher=native.NativeCBOWBatcher(
        pt, po, pv, pm.window, pm.sample))
    assert pm.train_metrics["pipeline_depth"] == 2
    assert jm.train_metrics["pipeline_depth"] == 2
    assert got[-1] < got[0] and want[-1] < want[0], (got, want)
    assert abs(got[-1] - want[-1]) / want[-1] < 0.125, (got, want)
    assert got[0] < 10.0 and want[0] < 10.0
    for a, b in zip(got[1:], want[1:]):
        assert abs(a - b) / b < 0.25, (got, want)


# ---------------------------------------------------------------------------
# no host read in a push or a step
# ---------------------------------------------------------------------------

def _no_host_reads(monkeypatch):
    def refuse(self, *a, **kw):
        raise AssertionError("a host read of a tensor")
    for name in ("tolist", "item", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


CAP, D, LR = 300, 16, 0.3


def _state(seed):
    rng = np.random.default_rng(seed)
    st = {f: ((rng.random((CAP, D)) - 0.5) / D).astype(np.float32)
          for f in ("h", "v")}
    for f in ("h2sum", "v2sum"):
        st[f] = np.abs(rng.normal(size=(CAP, D))).astype(np.float32) * 0.1
    return st


def _slots(rng, n):
    slots = (rng.zipf(1.2, n) - 1) % CAP
    slots[rng.random(n) < 0.1] = -1
    return slots.astype(np.int32)


@pytest.mark.parametrize("n", [40, 149, 20])
@pytest.mark.parametrize("families,mean", [(("h",), True),
                                           (("h", "v"), True),
                                           (("h",), False)])
def test_sparse_push_reads_no_host(monkeypatch, n, families, mean):
    """``_push_sparse`` with the host reads patched to raise gives the
    table it gives without the patch (which ``test_torch_transfer.py``
    holds against ``XlaTransfer``), bit for bit; n = 20 is all padding and
    updates nothing."""
    rng = np.random.default_rng(n)
    slots = _slots(rng, n)
    if n == 20:
        slots[:] = -1
    grads = {f: torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)
                                 * 0.05) for f in families}
    st = _state(3)
    want = state_from_jax(st, "cpu")
    SingleTransfer().push(want, torch.from_numpy(slots), grads,
                          w2v_access(LR, D), mean=mean)
    got = state_from_jax(st, "cpu")
    tr = SingleTransfer()
    with monkeypatch.context() as mp:
        _no_host_reads(mp)
        tr.push(got, torch.from_numpy(slots), grads, w2v_access(LR, D),
                mean=mean)
    assert dict(tr.push_paths) == {f"{','.join(families)}:sparse": 1}
    got, want = state_to_numpy(got), state_to_numpy(want)
    for f in st:
        np.testing.assert_array_equal(got[f], want[f])
    if n == 20:
        for f in st:
            np.testing.assert_array_equal(got[f], st[f])


@pytest.mark.parametrize("conf", [
    {}, {"stencil": 1}, {"shared_negatives": 1},
    {"stencil": 1, "shared_negatives": 1},
    {"transfer": "tpu", "server_num": 4},
    {"sg": 1}, {"sg": 1, "shared_negatives": 1}, {"dense_logits": 1},
    {"sg": 1, "transfer": "tpu", "server_num": 4}])
def test_training_step_reads_no_host(monkeypatch, corpus_file, conf):
    """One step of every rendering, and of the sharded server, through
    ``_step_fields`` with the host reads patched to raise: the step
    returns device scalars, and only the epoch's loss is read."""
    c = _conf(conf.get("stencil", 0))
    if "shared_negatives" in conf:
        c.set("word2vec", "shared_negatives", 1)
        c.set("word2vec", "shared_pool", 16)
    for key in ("sg", "dense_logits"):
        if key in conf:
            c.set("word2vec", key, conf[key])
    if "transfer" in conf:
        c.set("cluster", "transfer", "tpu")
        c.set("cluster", "server_num", conf["server_num"])
    model = Word2Vec(config=c, device="cpu", seed=2)
    batcher = _batcher("python", corpus_file, model)
    items = model._epoch_items(batcher, BATCH, model.stencil, False)
    fields = next(items)[1]
    with monkeypatch.context() as mp:
        _no_host_reads(mp)
        es, ec = model._step_fields(fields)
    assert isinstance(es, torch.Tensor) and isinstance(ec, torch.Tensor)
    assert np.isfinite(float(es)) and float(ec) > 0


def test_step_keeps_returning_host_numbers(corpus_file):
    model = Word2Vec(config=_conf(), device="cpu", seed=2)
    batcher = _batcher("python", corpus_file, model)
    batch = next(iter(batcher.epoch(BATCH)))
    es, ec = model.step_batch(batch)
    assert isinstance(es, float) and isinstance(ec, int) and ec > 0

