"""The started wave loops on both packages, on the CPU: the auto-mode
flip soak of ``test_active_set.py``, the idle loop's zero spurious
wakeups of ``test_command_plane.py`` and the threaded pipeline's
overlap of ``test_pipeline.py``, on ``ra_tpu`` and on ``ra_tpu_torch``
(its coordinators on ``device="cpu"``).

The scenarios live in ``tests/loop_cases.py``, which ``chip_smoke.py``
also runs on the card. They run on the wall clock, so two runs give no
equal records: each package's run makes the original's assertions, and
its final machine states must equal the totals its commands sum to, the
same for both packages.
"""

import pytest

import lane_cases as L
import loop_cases as LC
import torch_parity  # noqa: F401  (bounds torch's threads)
from torch_batch import PACKAGES, clear_both


def final_states(scenario):
    """Every replica's final machine state, by the scenario's defaults."""
    if scenario == "flip_soak":
        expect = [0] * 24
        for gids in LC.FLIP_BURSTS:
            for g in gids:
                expect[g] += 5
        return [expect] * 3
    if scenario == "idle_parking":
        return [3 + 1]
    return [50] * 3


@pytest.mark.parametrize("name", PACKAGES)
@pytest.mark.parametrize("scenario", sorted(LC.SCENARIOS))
def test_started_loop_on_both_packages(scenario, name):
    clear_both()
    try:
        rec = LC.SCENARIOS[scenario](L.Lane(name))
    finally:
        clear_both()
    assert rec["states"] == final_states(scenario)
