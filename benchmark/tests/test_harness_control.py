"""The output check's control comes out not correct: the program's own
lower-precision path (``[server] dtype: bfloat16`` tables) and the
reference in TF32, each in the program's place, at a size a test run
holds.  Needs the card; the readings at the cells' own sizes come from
``benchmark/calibrate.py``."""

import pytest
import torch

from benchmark.models import word2vec
from benchmark.reference import check
from benchmark.tests.conftest import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["w2v_cbow_text8.xla",
                                  "w2v_sg_gnews300.xla"])
def test_control_fails_the_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("the control's precision exists only on the card")
    cell = tiny(name)
    r = word2vec.readings(cell, 5, ("program", "bf16", "half_batch"),
                           "cuda")
    limits = {k: v for k, v in cell.limits.items() if k in r["program"]}
    assert check.judge(r["program"], limits)
    assert not check.judge(r["bf16"], limits)
    assert not check.judge(r["half_batch"], limits)
