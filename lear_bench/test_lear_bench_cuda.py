"""The harness on the card at the smoke config's sizes (run with
``-m cuda`` on a machine with an H100): a sound run is correct, the
control is not. Skips where no card is visible."""

import time

import pytest

torch = pytest.importorskip("torch")

from lear_bench import harness  # noqa: E402
from lear_bench.control import ControlService  # noqa: E402
from lear_bench.smallcell import small_cell  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("sentinel2", [0, 12])
def test_on_the_card(card, sentinel2):
    cell = small_cell(sentinel2=sentinel2, queries=64)
    for service, correct in ((None, True), (ControlService, False)):
        r = harness.run(cell, 2**31 + 5, 0.3, True, card, time.perf_counter(),
                        log=lambda msg: None, service=service)
        assert r["correct"] is correct
        assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
