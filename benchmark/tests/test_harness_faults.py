"""A run with its timed path broken underneath reads ``correct`` false:
once for each fault a one-card training cell can have (it has no
exchange between chips).  The harness's look for a card is skipped: the
run drives the same path on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import harness
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.models import word2vec
from swiftmpi_tpu_torch.parameter import access
from swiftmpi_tpu_torch.transfer import single


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(access.AdaGradAccess, "apply_push",
                        lambda self, params, grads, mul=None, div=None: {})
    monkeypatch.setattr(access.AdaGradAccess, "apply_push_rows",
                        lambda self, state, slots, mask, grads, mul=None: {})


def _half_batch(monkeypatch):
    grads_for = word2vec.Word2Vec._grads_for

    def half(self, state, fields, draws=None):
        c, x, m = fields
        m = torch.as_tensor(np.asarray(m)).clone()
        m[m.shape[0] // 2:] = False
        return grads_for(self, state, (c, x, m), draws)
    monkeypatch.setattr(word2vec.Word2Vec, "_grads_for", half)


def _token_altered(monkeypatch):
    epoch = native.PrefetchingCBOWBatcher.epoch

    def altered(self, batch_size):
        for b in epoch(self, batch_size):
            b.centers[0] = (int(b.centers[0]) + 1) % len(self.vocab)
            yield b
    monkeypatch.setattr(native.PrefetchingCBOWBatcher, "epoch", altered)


def _answer_altered(monkeypatch):
    gather = single.masked_gather

    def altered(table, slots, valid, out=None):
        rows = gather(table, slots, valid, out)
        rows[0] += 0.01
        return rows
    monkeypatch.setattr(single, "masked_gather", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_not_correct(monkeypatch, tiny_cell, fault):
    FAULTS[fault](monkeypatch)
    result = harness.run_cell(None, 99, 0.3, False, device="cpu",
                              cell=tiny_cell, log=lambda *a: None)
    assert result["correct"] is False, result["check"]
