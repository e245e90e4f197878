"""The FLOP and byte counts against hand counts at a small shape."""

import torch

from benchmark.roofline import adagrad, gather, w2v_step

T, F = True, False


def cbow_step():
    return (torch.tensor([5, 7]), torch.tensor([[1, 2], [3, 0]]),
            torch.tensor([[T, T], [T, F]]), torch.tensor([[5, 9], [8, 8]]))


def sg_step():
    return (torch.tensor([5]), torch.tensor([[1, 2]]), torch.tensor([[T, F]]),
            torch.tensor([[[3, 5], [4, 4]]]))


def test_kernel_bytes():
    assert gather.bytes_moved(6, 4, 4) == 6 * 5 + 4 * 16 + 6 * 16
    assert adagrad.bytes_moved_rows(6, 4, 4) == 6 * 9 + 4 * 16 * 5
    assert adagrad.bytes_moved_table(10, 4) == 10 * (16 * 5 + 4)


def test_cbow_step_counts():
    # live targets: row 0 drops its negative equal to the center -> 2 + 3
    assert w2v_step.flops(False, 4, *cbow_step()) == 5 * 5 * 4 + 3 * 4
    got = w2v_step.launch_bytes(False, 4, 100, *cbow_step())
    # h: 6 slots, distinct live rows {5, 9, 7, 8}; v: 4 slots, {1, 2, 3}
    assert got == {"gather": (30 + 64 + 96) + (20 + 48 + 64),
                   "adagrad": (54 + 320) + (36 + 240)}


def test_sg_step_counts():
    # one live pair: the center and one negative (the other equals it)
    assert w2v_step.flops(True, 4, *sg_step()) == 2 * 5 * 4
    got = w2v_step.launch_bytes(True, 4, 100, *sg_step())
    assert got == {"gather": (30 + 32 + 96) + (10 + 16 + 32),
                   "adagrad": (54 + 160) + (18 + 80)}


def test_dense_push_is_not_counted_by_the_row_form():
    # 6 h slots reach half of a capacity of 12: the push goes dense
    got = w2v_step.launch_bytes(False, 4, 12, *cbow_step())
    assert got["adagrad"] == 36 + 240
