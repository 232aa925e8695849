"""The card's kernels against the plain reference on the host CPU backend,
at the widths the system runs (chip_smoke.py's kernel phase).

Each check jits the same code for the GPU and for the CPU of one process:
FAST scores and keypoints, the gated projection search, and LK. They skip
without a GPU; tests/test_card_harness.py runs the same checks CPU against
CPU at small sizes.
"""
import pytest

import chip_smoke as CS

pytestmark = pytest.mark.gpu


def test_fast_on_card(card, host):
    print("\n" + CS.check_fast(card, host))


def test_search_on_card(card, host):
    print("\n" + CS.check_search(card, host))


def test_lk_on_card(card, host):
    print("\n" + CS.check_lk(card, host))
