"""The control (the reference in the program's place, its feature table
read in float8) fails the committed limits of every cell, where the
program passes them, on the CPU at a tiny size. ``portbench/control.py``
reads the same at the cells' own sizes on the card."""

from __future__ import annotations

import json

import pytest

from portbench import checks, control
from portbench.tests import helpers


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return helpers.tiny_checkout(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", helpers.TINY_CELLS)
def test_the_control_fails_where_the_program_passes(checkout, cell):
    limits = json.loads((checkout / "portbench" / "limits"
                         / f"{cell}.json").read_text())
    lines = list(control.readings(checkout, cell, [31, 32], 0.2,
                                  ("fp8_table",), device="cpu"))
    for line in lines:
        assert checks.within(line["program"], limits), line
        assert not checks.within(line["fp8_table"], limits), line
