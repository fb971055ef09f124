"""A run with the timed path broken underneath must come out not
correct: the harness's look for a card is skipped (CPU, tiny sizes) and
the rest of the run is driven with the program patched by the faults of
``portbench/faults.py``, which reads the same at the cells' own sizes
on the card."""

from __future__ import annotations

import pytest

from portbench.faults import FrameFault, TrainFault
from portbench.tests import helpers


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return helpers.tiny_checkout(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["occ-localize", "occ-track"])
@pytest.mark.parametrize("how", FrameFault.KINDS)
def test_a_broken_frame_is_not_correct(checkout, how, cell):
    rc, result, err = helpers.run_cpu(checkout, cell, seed=21,
                                      hooks=FrameFault(how))
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ["occ-train", "dense-train"])
@pytest.mark.parametrize("how", TrainFault.KINDS)
def test_a_broken_step_is_not_correct(checkout, cell, how):
    rc, result, err = helpers.run_cpu(checkout, cell, seed=22,
                                      hooks=TrainFault(how))
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
