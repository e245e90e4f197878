"""Tiny cells for the harness's CPU tests: each manifest cell with its
configuration and traffic cut to a size a test run holds.  A run on the
CPU drives the same path with the kernels' plain versions and no CUDA
graphs; it measures nothing."""

import copy

import pytest

from benchmark import spec

TINY_CONFIG = {
    "w2v_cbow_text8.xla": dict(corpus_tokens=60000, distinct_words=6000,
                               top_count=4000, words_at_min_count=1500,
                               knee_rank=100, sentence_length=200,
                               len_vec=16, negative=5, sample=1e-3),
    "w2v_sg_gnews300.xla": dict(vocab_size=20000, corpus_sentences=200,
                                sentence_length=200, len_vec=16,
                                source_corpus_words=1e8, sample=1e-3),
}
TINY_TRAFFIC = dict(batch_centers=256, inner_steps=4, pipeline=2)


def tiny(name: str) -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config.update(TINY_CONFIG[name])
    cell.traffic.update(TINY_TRAFFIC)
    return cell


@pytest.fixture(params=sorted(TINY_CONFIG))
def tiny_cell(request) -> spec.Cell:
    return tiny(request.param)
