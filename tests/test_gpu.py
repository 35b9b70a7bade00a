"""Checks that need the card: the compiled Triton kernel against the XLA
engine, the XLA engine on the GPU against the CPU, and a short fit.  They
run chip_smoke.py's phases at small sizes and skip without a GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pytestmark = pytest.mark.gpu


def test_kernel_parity_on_card(gpu):
    import chip_smoke

    chip_smoke.phase_parity(128, 96)


def test_card_matches_cpu(gpu):
    import chip_smoke

    chip_smoke.phase_cpu(32, 24)


def test_fit_on_card(gpu):
    import chip_smoke

    chip_smoke.phase_fit(64, 64, steps=3)
