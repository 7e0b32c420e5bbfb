"""Every cell on the card, briefly: the timed path at the cell's own size
comes out correct.  Skips without a card; on one:
``python -m pytest -q -m cuda perfbench/tests``."""
import pytest

from perfbench import harness

from .sizes import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell, card):
    out = harness.run_cell(cell, 2**31 + 3, 2.0, False, device=str(card))
    res = out["result"]
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
