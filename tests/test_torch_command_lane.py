"""``tests/test_command_lane.py`` on both packages: the deterministic
command-lane regression tier (deposed-leader and truncated-command
redirects, admission, the pipeline window, vote-grant damping, internal
commands) and the watchdog, on ``ra_tpu`` and on ``ra_tpu_torch`` (its
coordinators on the CPU).

The scenarios live in ``tests/lane_cases.py``, which ``chip_smoke.py``
also runs on the card. A hand-stepped scenario makes the original's
assertions on each package, and the two records (replies, counters,
roles, terms, log tails, the group's device row) must be equal,
exactly. The wall-clock ones (the watchdog on started coordinators, the
retry after a reject under a pump thread) make the original's assertions
on each package. The flake gate's deposed-leader half (20 runs in each
active-set mode, ``tests/test_flake_gate.py``) runs on the port, slow.
"""

import pytest

import lane_cases as L
import torch_parity  # noqa: F401  (bounds torch's threads)
from torch_batch import PACKAGES, clear_both


def on_both(flow, *args):
    got = {}
    for name in PACKAGES:
        clear_both()
        try:
            got[name] = flow(L.Lane(name), *args)
        except Exception as e:
            raise AssertionError(f"{flow.__name__} on {name}: {e!r}") from e
        finally:
            clear_both()
    return got


@pytest.mark.parametrize("mode", L.MODES)
@pytest.mark.parametrize("name", L.MODED)
def test_redirect_on_both_packages(name, mode):
    got = on_both(L.DETERMINISTIC[name], mode)
    assert got["ra_tpu_torch"] == got["ra_tpu"]


@pytest.mark.parametrize("name", [n for n in L.DETERMINISTIC
                                  if n not in L.MODED])
def test_lane_case_on_both_packages(name):
    got = on_both(L.DETERMINISTIC[name])
    assert got["ra_tpu_torch"] == got["ra_tpu"]


def test_process_command_retries_after_reject_on_both_packages():
    on_both(L.retry_after_reject)


@pytest.mark.parametrize("mode", L.MODES)
def test_watchdog_bounds_wedged_lane_on_both_packages(mode):
    got = on_both(L.watchdog, mode)
    for rec in got.values():
        assert rec["verdict"] == "maybe"
        assert rec["lane_wedges"] >= 1 and rec["lane_recoveries"] >= 1


@pytest.mark.slow
@pytest.mark.flake_gate
@pytest.mark.parametrize("mode", L.MODES)
def test_deposed_leader_regression_20x_on_port(mode):
    """``tests/test_flake_gate.py``'s 20x repetition of the deposed-leader
    case, on the port."""
    lane = L.Lane("ra_tpu_torch")
    for i in range(20):
        clear_both()
        try:
            L.deposed_leader_redirect(lane, mode)
        except Exception as e:  # noqa: BLE001 — annotate the iteration
            raise AssertionError(
                f"flake gate: regression run {i + 1}/20 failed under "
                f"active_set={mode!r}: {e}") from e
        finally:
            clear_both()
