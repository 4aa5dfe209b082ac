"""The linearizability checker and its live workloads on the port, on
the CPU.

1. The checker's unit histories of ``tests/test_linearizability.py``
   go through ``check_register`` and ``check_history`` of both packages:
   the verdicts and the violation strings must be equal.
2. The live workloads run on the port at the reference's seeds and
   sizes: the batch backend (seed 9, its coordinators on
   ``device="cpu"``) and the actor backend (seed 7), each 4 clients x
   30 ops, must verify linearizable.
3. The planted stale-read bug (consistent queries answered without the
   leadership-confirmation quorum) is caught on the port in each
   ``active_set`` mode. The scenario is ``chip_smoke.stale_read_scenario``,
   the one that runs on the card, here on the CPU.
"""

import importlib.util
import math
import os

import pytest
import torch

import ra_tpu.linearize as ref_lin
import ra_tpu_torch.linearize as port_lin

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- 1. the checker on both packages ----------------------------------------

# (name, history) with ops as (client, kind, value, inv, ret): the
# synthetic histories of tests/test_linearizability.py:29-118
_T = math.inf
REGISTER_CASES = {
    "sequential": [(0, "write", "a", 0.0, 1.0), (0, "read", "a", 2.0, 3.0),
                   (0, "write", "b", 4.0, 5.0), (0, "read", "b", 6.0, 7.0)],
    "reads_split_around_write": [(0, "write", "v", 1.0, 5.0),
                                 (1, "read", None, 1.5, 4.0),
                                 (2, "read", "v", 2.0, 4.5)],
    "stale_read": [(0, "write", "v", 0.0, 1.0), (1, "read", None, 2.0, 3.0)],
    "lost_write": [(0, "write", "a", 0.0, 1.0), (0, "write", "b", 2.0, 3.0),
                   (1, "read", "a", 4.0, 5.0)],
    "indeterminate_applied": [(0, "write", "x", 1.0, _T),
                              (1, "read", "x", 2.0, 3.0)],
    "indeterminate_not_applied": [(0, "write", "x", 1.0, _T),
                                  (1, "read", None, 2.0, 3.0)],
    "indeterminate_after_later_write": [
        (0, "write", "x", 1.0, _T), (1, "write", "y", 2.0, 3.0),
        (1, "read", "y", 4.0, 5.0), (1, "read", "x", 6.0, 7.0)],
    "indeterminate_applied_twice": [
        (0, "write", "x", 1.0, _T), (1, "write", "y", 2.0, 3.0),
        (1, "read", "x", 4.0, 5.0), (1, "read", "y", 6.0, 7.0),
        (1, "read", "x", 8.0, 9.0)],
    "real_time_order": [(0, "write", "first", 0.0, 1.0),
                        (1, "write", "second", 2.0, 3.0),
                        (2, "read", "first", 4.0, 5.0)],
}
# the reference tests' verdicts: True = linearizable
EXPECTED = {
    "sequential": True, "reads_split_around_write": True,
    "stale_read": False, "lost_write": False,
    "indeterminate_applied": True, "indeterminate_not_applied": True,
    "indeterminate_after_later_write": True,
    "indeterminate_applied_twice": False, "real_time_order": False,
}


def _ops(mod, rows):
    return [mod.Op(*r) for r in rows]


@pytest.mark.parametrize("name", sorted(REGISTER_CASES))
def test_check_register_equal_on_both_packages(name):
    rows = REGISTER_CASES[name]
    ref = ref_lin.check_register(_ops(ref_lin, rows))
    port = port_lin.check_register(_ops(port_lin, rows))
    assert (port is not None) == (ref is not None) == EXPECTED[name]
    assert port == ref


def test_check_history_equal_on_both_packages():
    hist = {name: rows for name, rows in REGISTER_CASES.items()}
    ref = ref_lin.check_history({k: _ops(ref_lin, v) for k, v in hist.items()})
    port = port_lin.check_history({k: _ops(port_lin, v) for k, v in hist.items()})
    assert (port.ok, port.per_key_ops) == (ref.ok, ref.per_key_ops)
    assert port.violations == ref.violations
    assert len(port.violations) == sum(not v for v in EXPECTED.values())


# -- 2. live runs on the port -------------------------------------------------


def test_live_batch_backend_linearizable_on_port():
    res = port_lin.run_workload(seed=9, backend="tpu_batch", n_clients=4,
                                ops_per_client=30, device="cpu")
    assert res.ok, res.violations
    assert sum(res.per_key_ops.values()) > 30


def test_live_actor_backend_linearizable_on_port():
    res = port_lin.run_workload(seed=7, backend="per_group_actor",
                                n_clients=4, ops_per_client=30)
    assert res.ok, res.violations
    assert sum(res.per_key_ops.values()) > 30


def test_batch_backend_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_lin.run_workload(seed=9, backend="tpu_batch", n_clients=1,
                              ops_per_client=1)


# -- 3. the planted stale-read bug is caught ----------------------------------


@pytest.mark.parametrize("active_set", ["auto", "always", "never"])
def test_injected_stale_read_bug_is_caught_on_port(active_set):
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    orig = BatchCoordinator._handle_consistent_query
    violations = _chip_smoke().stale_read_scenario(active_set, "cpu")
    assert violations and all("not linearizable" in v for v in violations)
    assert BatchCoordinator._handle_consistent_query is orig


@pytest.mark.slow
@pytest.mark.flake_gate
@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_injected_stale_read_20x_on_port(mode):
    """``tests/test_flake_gate.py``'s 20x repetition, on the port."""
    smoke = _chip_smoke()
    for i in range(20):
        try:
            smoke.stale_read_scenario(mode, "cpu")
        except Exception as e:  # noqa: BLE001 — annotate the iteration
            raise AssertionError(
                f"flake gate: run {i + 1}/20 failed under active_set="
                f"{mode!r}: {e}") from e
