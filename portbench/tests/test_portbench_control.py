"""The control (the reference a precision below the configuration's, in
the program's place) is not correct under each cell's limits, on the card
at the cell's own size."""

import pytest

from portbench import compare, control, manifest

CELLS = ("celeb_unlearn_b64", "celeb_sample_ddpm50_b64")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_its_limits_on_the_card(card, cell):
    numbers = control.control_numbers(cell, 2 ** 31 + 515, device=card)
    assert not compare.judge(numbers, manifest.limits(cell)), numbers
