"""The control comes out not correct: each one-card cell's reference,
computed in float8 (the precision below the configurations' bf16) and put
in the program's place, fails at least one of the cell's numbers against
the cell's limits, at the cell's own sizes, on three seeds. On the card
only:

    python -m pytest vtbench/tests/test_vtb_control.py -m cuda
"""

import pytest

from vtbench import compare, registry
from vtbench.tests import tiny

CELLS = ("tsf_b.serve.poisson", "tsf_b.finetune.b32", "mvit_b.maskfeat.b32")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3200000001, 3200000002, 3200000003])
def test_the_control_is_not_correct(card, cell, seed):
    from vtbench import calibrate

    c = registry.cell(tiny.REPO, cell)
    if c.traffic["driver"] == "serve":
        got = calibrate.serve_numbers(c, seed, card, "control", 3.0)
    else:
        got = calibrate.train_numbers(c, seed, card, "control")
    limits = compare.limits(tiny.REPO, cell)
    assert any(got[k] > limits[k] for k in got), (got, limits)
