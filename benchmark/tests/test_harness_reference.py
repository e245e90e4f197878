"""The plain reference agrees with a tiny CPU run of the port: one step
with the same draws, and the harness's own comparison of the checked
steps (a one-step call, then groups of the window's length)."""

import numpy as np
import pytest
import torch

from benchmark import harness, traffic, weights
from benchmark.models import word2vec as w2v_model
from benchmark.reference import check, w2v as ref
from benchmark.tables import xla
from benchmark.tests.conftest import tiny
from swiftmpi_tpu_torch.data.text import Vocab


@pytest.mark.parametrize("name", ["w2v_cbow_text8.xla",
                                  "w2v_sg_gnews300.xla"])
def test_one_step_with_the_same_draws(name):
    cell = tiny(name)
    cfg = cell.config
    tokens, offsets, keys, counts = traffic.make_corpus(cfg, 7)
    vocab = Vocab(keys, counts)
    model = w2v_model.build_model(cfg, cell.traffic, vocab, 7, "cpu")
    V, d = len(vocab), int(cfg["len_vec"])
    slots = xla.slots(model, vocab.keys)
    weights.hand_to_program(xla, model, slots, 7, V, d)
    rng = np.random.default_rng(3)
    B, W2 = 64, 2 * int(cfg["window"])
    centers = rng.integers(0, V, B)
    contexts = rng.integers(0, V, (B, W2))
    mask = rng.random((B, W2)) < 0.7
    mask[:, 0] = True
    contexts[~mask] = 0
    draws = ref.Draws(1, V, ref.draw_shape(cfg, B), "cpu")
    j, u = draws.next()
    es, ec = model.step(centers, contexts, mask, draws=(j, u))

    rmodel = ref.Model(cfg, counts, "cpu")
    batch = (torch.as_tensor(centers), torch.as_tensor(contexts),
             torch.as_tensor(mask))
    out = ref.run_steps(rmodel, [batch], [rmodel.negatives(j, u)],
                        lambda f, idx: weights.rows(7, f, V, d, idx))
    rows = out["rows"]
    for f in ("h", "v"):
        got = model.table.state[f][slots[rows]]
        torch.testing.assert_close(got, out["final"][f], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(
            model.table.state[f + "2sum"][slots[rows]], out["acc1"][f],
            rtol=1e-5, atol=1e-12)
    assert es / max(round(ec), 1) == pytest.approx(out["losses"][0],
                                                   rel=1e-6)


def test_first_steps_agree(tiny_cell):
    run = w2v_model.Program(tiny_cell, 2024, torch.device("cpu"),
                            harness.Parts(torch.device("cpu")))
    run.checked_steps()
    assert run.calls == [1, w2v_model.CHECK_GROUPS * tiny_cell.traffic[
        "inner_steps"]] and len(run.checked) == sum(run.calls)
    run.release()
    nums = run.numbers()
    assert nums["loss_gap"] < 1e-6
    assert nums["grad_norm_gap"] < 1e-6
    assert nums["update_norm_gap"] < 1e-6
    assert nums["rows_outside_vocab"] == 0 and nums["unlocated_rows"] == 0
    assert check.judge(nums, {k: v for k, v in tiny_cell.limits.items()
                              if k in nums})
