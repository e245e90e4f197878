"""The port's native C++ loader binding (swiftmpi_tpu_torch/data/native.py)
against the JAX package's (swiftmpi_tpu/data/native.py): one C++ library,
one seed, so vocab, corpus, batches, libSVM parses and row dumps must be
array-equal (dumps byte-equal).

The port builds its own copy of the library from ``native/*.cpp`` into a
temporary build directory here (``data/native.py`` ``BUILD_ROOT``), never
into the tracked ``native/libsmtpu_loader.so``.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from swiftmpi_tpu.data import native as jnative
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.data.text import (build_vocab, load_corpus,
                                          synthetic_corpus, write_tokens_file)

ROOT = Path(__file__).resolve().parents[1]
TRACKED_SO = ROOT / "native" / "libsmtpu_loader.so"


def _fingerprint(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


@pytest.fixture(scope="module")
def port_native(tmp_path_factory):
    """The port's binding built into a temporary build directory, with the
    tracked library's bytes before and after the port's build and load.
    The JAX binding loads first: it rebuilds the tracked file in place
    when the sources are newer, which is its behaviour, not the port's."""
    assert jnative.available()
    before = _fingerprint(TRACKED_SO)
    build_root = tmp_path_factory.mktemp("native_build")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_ROOT", build_root)
        assert native.available()
        lib_path = native.library_path()
        after = _fingerprint(TRACKED_SO)
        yield native, build_root, lib_path, before, after


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    """A Zipf corpus with two lines longer than the 1,000-token sentence
    cap, which both loaders cut into pieces."""
    path = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    sents = synthetic_corpus(300, 400, 17, seed=4)
    sents += synthetic_corpus(2, 400, 2_300, seed=5)
    write_tokens_file(sents, str(path))
    return str(path)


def test_build_goes_to_its_own_directory(port_native):
    _, build_root, lib_path, before, after = port_native
    assert lib_path.exists()
    assert lib_path.parent.parent == build_root
    assert lib_path.parent.name == native.digest()
    assert TRACKED_SO.resolve() != lib_path.resolve()
    assert before == after


def test_build_key_follows_sources_and_flags(port_native, monkeypatch):
    d = native.digest()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    assert native.digest() != d


def test_load_corpus_matches_jax(port_native, corpus_file):
    pn = port_native[0]
    pv, pt, po = pn.load_corpus_native(corpus_file)
    jv, jt, jo = jnative.load_corpus_native(corpus_file)
    np.testing.assert_array_equal(pv.keys, jv.keys)
    np.testing.assert_array_equal(pv.counts, jv.counts)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(po, jo)
    assert pt.dtype == np.int32 and po.dtype == np.int64
    assert len(po) - 1 > 302          # the long lines were cut


def test_native_vocab_equals_build_vocab(port_native, corpus_file):
    pv, tokens, offsets = port_native[0].load_corpus_native(corpus_file)
    want = build_vocab(load_corpus(corpus_file))
    np.testing.assert_array_equal(pv.keys, want.keys)
    np.testing.assert_array_equal(pv.counts, want.counts)
    assert len(tokens) == want.total_words


def _batchers(port_native, corpus_file, prefetch, sample, window=3):
    pn = port_native[0]
    pv, pt, po = pn.load_corpus_native(corpus_file)
    jv, jt, jo = jnative.load_corpus_native(corpus_file)
    if prefetch:
        return (pn.PrefetchingCBOWBatcher(pt, po, pv, window, sample,
                                          seed=7, depth=3),
                jnative.PrefetchingCBOWBatcher(jt, jo, jv, window, sample,
                                               seed=7, depth=3))
    return (pn.NativeCBOWBatcher(pt, po, pv, window, sample, seed=7),
            jnative.NativeCBOWBatcher(jt, jo, jv, window, sample, seed=7))


_FIELDS = {"epoch": ("centers", "contexts", "ctx_mask"),
           "epoch_stencil": ("tokens", "sent_id", "center_pos", "half")}


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("sample", [-1.0, 1e-3])
@pytest.mark.parametrize("epoch", ["epoch", "epoch_stencil"])
def test_batches_match_jax_over_two_epochs(port_native, corpus_file,
                                           prefetch, sample, epoch):
    pb, jb = _batchers(port_native, corpus_file, prefetch, sample)
    for _ in range(2):
        got = list(getattr(pb, epoch)(96))
        want = list(getattr(jb, epoch)(96))
        assert len(got) == len(want) > 3
        for a, b in zip(got, want):
            assert a.n_words == b.n_words
            for f in _FIELDS[epoch]:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_prefetching_epochs_equal_synchronous_ones(port_native, corpus_file):
    sync, _ = _batchers(port_native, corpus_file, False, 1e-3)
    pre, _ = _batchers(port_native, corpus_file, True, 1e-3)
    for epoch in _FIELDS:
        a, b = list(getattr(sync, epoch)(64)), list(getattr(pre, epoch)(64))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for f in _FIELDS[epoch]:
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


_LIBSVM = ("1 3:1 11:0.5 42:2\n"
           "-1 2:0.25\n"
           "0 5:1.5 7:2 18446744073709551615:1\n"
           "+1 1:3\n")


def test_parse_libsvm_matches_jax(port_native, tmp_path):
    path = tmp_path / "a.svm"
    path.write_text(_LIBSVM)
    got = port_native[0].parse_libsvm_native(str(path))
    want = jnative.parse_libsvm_native(str(path))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 4


def test_parse_libsvm_refuses_malformed_lines(port_native, tmp_path):
    path = tmp_path / "bad.svm"
    path.write_text("1 3:1\nx 2:0.5\n")
    with pytest.raises(ValueError, match="malformed"):
        port_native[0].parse_libsvm_native(str(path))
    with pytest.raises(ValueError, match="malformed"):
        jnative.parse_libsvm_native(str(path))


@pytest.mark.parametrize("n", [0, 1, 57])
def test_dump_rows_byte_equal_and_load_matches(port_native, tmp_path, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
    fields = [rng.normal(size=(n, 5)).astype(np.float32),
              (rng.random((n, 3)) * 1e-7).astype(np.float32)]
    pp, jp = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert port_native[0].dump_rows_native(str(pp), keys, fields) == n
    assert jnative.dump_rows_native(str(jp), keys, fields) == n
    assert pp.read_bytes() == jp.read_bytes()
    if not n:
        return
    pk, pf = port_native[0].load_rows_native(str(pp), [5, 3])
    jk, jf = jnative.load_rows_native(str(jp), [5, 3])
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pk, keys)
    for a, b, src in zip(pf, jf, fields):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, src)     # lossless text floats


def test_missing_file_raises(port_native, tmp_path):
    with pytest.raises(FileNotFoundError):
        port_native[0].load_corpus_native(str(tmp_path / "none.txt"))
