"""The KV/FIFO consistency harness and the nemesis planner on the port,
on the CPU.

``ra_tpu_torch.kv_harness.run`` runs at the tier-1 seeds of the JAX
package's harness tests, with their op counts, timeouts and assertions
(``tests/test_kv_harness.py``, ``tests/test_soak.py``); the batch
backend's coordinators run on ``device="cpu"``. The fifo workload on the
batch backend runs on both packages at the soak's seeds. The runs are wall-clock
driven, so each package is held to the assertions, not to the other
package's op counts. The lease and disk-full seeds are in
``tests/test_torch_harness_faults.py``.

The nemesis planners are compared directly: for seeds 1, 7 and 23 a
``Planner`` over every dimension of ``standard_dimensions`` is stepped
in each package against a stub ``NemesisContext`` that only records
what it is asked to do. The planned actions, the calls on the context,
the armed failpoints and the counters must be equal, exactly. The
combined regime's nemesis schedule, which replays from the seed alone,
must be equal across the packages too (``test_soak.py``'s
``test_schedule_replayable_from_seed``, on both).
"""

import random

import pytest
import torch

import ra_tpu.faults as ref_faults
import ra_tpu.kv_harness as ref_harness
import ra_tpu.nemesis as ref_nem
import ra_tpu_torch.faults as port_faults
import ra_tpu_torch.kv_harness as port_harness
import ra_tpu_torch.nemesis as port_nem

torch.set_num_threads(1)

BATCH = dict(backend="tpu_batch", device="cpu")


# -- the batch backend on the port (tests/test_kv_harness.py seeds) ---------


@pytest.mark.parametrize("seed", [21, 36])
def test_kv_harness_batch_backend_randomized_on_port(seed):
    res = port_harness.run(seed=seed, n_ops=100, rescue=False, **BATCH)
    assert res.consistent, res.failures
    assert res.ops.get("put", 0) > 0


def test_kv_harness_overload_batch_on_port():
    res = port_harness.run(seed=51, n_ops=30, partitions=False,
                           membership=False, overload=True, **BATCH)
    assert res.consistent, res.failures
    assert res.ops.get("overload_acked", 0) > 0


def test_combined_smoke_batch_on_port():
    """``tests/test_soak.py::test_combined_smoke_batch``: every dimension
    at once, crash-restarts from the WAL and live mode flips included."""
    res = port_harness.run(seed=2, n_ops=60, combined=True, **BATCH)
    assert res.consistent, res.failures
    assert res.nemesis.get("nemesis_modeflip_injected", 0) > 0


def test_combined_smoke_batch_native_off_on_port():
    """``tests/test_soak.py::test_combined_smoke_batch_native_off``: the
    combined regime over the pure-Python command plane."""
    res = port_harness.run(seed=3, n_ops=60, combined=True, native="off",
                           **BATCH)
    assert res.consistent, res.failures


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fifo_harness_batch_backend_on_both_packages(seed):
    """The fifo machine (quorum queues) on the batch backend, at
    ``tests/test_soak.py``'s seeds: partitions and membership churn
    under enqueue/checkout/settle/return/down traffic. Each package's
    run is consistent: the checker found no acknowledged enqueue lost,
    none applied twice (a payload under two msg_ids), the final drain
    emptied the queue and a release cursor snapshotted a replica."""
    for harness, kw in ((ref_harness, {}), (port_harness, BATCH)):
        kw = dict(kw, backend="tpu_batch")
        res = harness.run(seed=seed, n_ops=40, workload="fifo", **kw)
        assert res.consistent, (harness.__name__, res.failures)
        assert not res.failures
        assert res.ops.get("fifo_settled", 0) > 0, (harness.__name__, res.ops)


def test_kv_harness_actor_backend_randomized_on_port():
    res = port_harness.run(seed=11, n_ops=120, backend="per_group_actor",
                           rescue=False)
    assert res.consistent, res.failures
    assert res.ops.get("put", 0) > 0 and res.ops.get("get", 0) > 0


def test_batch_backend_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_harness.run(seed=21, n_ops=1, backend="tpu_batch")


# -- nemesis parity -----------------------------------------------------------


NODES = ["n0", "n1", "n2"]
SPARE = "n3"


def _plan(nem, faults, seed: int):
    """Every action a planner over all nine dimensions takes in 300 ops
    against a recording context: half the ops step the planner's own
    schedule (the combined regime), half fire a dimension from the
    workload's dice (the flag-gated regime)."""
    calls = []
    members = list(NODES)
    mode = ["auto"]

    def membership_step():
        if SPARE in members:
            members.remove(SPARE)
            what = "remove"
        else:
            members.append(SPARE)
            what = "add"
        calls.append(("membership", what))
        return what

    def set_mode(m):
        calls.append(("set_mode", m))
        mode[0] = m

    def burst():
        calls.append(("burst",))
        return 25

    ctx = nem.NemesisContext(
        peers=lambda: NODES + [SPARE],
        members=lambda: list(members),
        block=lambda a, b: calls.append(("block", a, b)),
        unblock_all=lambda: calls.append(("unblock_all",)),
        restart=lambda n: calls.append(("restart", n)),
        membership_step=membership_step,
        fault_scopes=lambda: [None] + NODES,
        overload_burst=burst,
        set_mode=set_mode,
        get_mode=lambda: mode[0],
    )
    dims = nem.standard_dimensions(
        partitions=True, oneway=True, disk_faults=True, disk_full=True,
        slow_disk=True, restarts=True, membership=True, overload=True,
        mode_flips=True)
    names = [d.name for d in dims]
    dice = random.Random(seed)
    armed = []
    with nem.Planner(ctx, seed, f"parity{seed}", dims) as planner:
        for i in range(300):
            if i % 2:
                planner.step(i)
            elif dice.random() < 0.3:
                planner.fire(dice.choice(names), dice, i)
            if i % 50 == 49:
                planner.heal_transient(i)
            armed.append(sorted(faults.armed_sites().items()))
        counters = planner.counters()
        schedule = list(planner.schedule)
    assert not faults.anything_armed()
    return {"schedule": schedule, "calls": calls, "armed": armed,
            "counters": counters}


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_nemesis_planner_equal_on_both_packages(seed):
    ref = _plan(ref_nem, ref_faults, seed)
    port = _plan(port_nem, port_faults, seed)
    assert len(ref["schedule"]) > 40
    # every dimension fired
    assert {s[1] for s in ref["schedule"] if s[2] == "inject"} == {
        "partition", "oneway", "disk", "disk_full", "slow_disk", "crash",
        "membership", "overload", "modeflip"}
    for k in ref:
        assert port[k] == ref[k], k


def test_combined_schedule_equal_on_both_packages():
    """The combined regime's schedule depends on the seed alone: equal
    on the two packages (``test_schedule_replayable_from_seed``)."""
    a = ref_harness.run(seed=5, n_ops=60, combined=True)
    b = port_harness.run(seed=5, n_ops=60, combined=True)
    assert a.consistent and b.consistent, (a.failures, b.failures)
    assert a.schedule, "combined run produced an empty nemesis schedule"
    assert b.schedule == a.schedule


# -- the slow matrices of the reference, on the port --------------------------


def _device(backend):
    return {"device": "cpu"} if backend == "tpu_batch" else {}


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["tpu_batch", "per_group_actor"])
@pytest.mark.parametrize("seed", [53, 54, 55])
def test_kv_harness_overload_matrix_on_port(backend, seed):
    res = port_harness.run(seed=seed, n_ops=60, backend=backend,
                           overload=True, **_device(backend))
    assert res.consistent, res.failures
    assert res.ops.get("overload_acked", 0) > 0


@pytest.mark.slow
@pytest.mark.soak
@pytest.mark.parametrize("workload", ["kv", "fifo"])
@pytest.mark.parametrize("backend", ["per_group_actor", "tpu_batch"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_combined_soak_on_port(seed, backend, workload):
    res = port_harness.run(seed=seed, n_ops=200, backend=backend,
                           workload=workload, combined=True, native="auto",
                           **_device(backend))
    assert res.consistent, res.failures
    dims = ("partition", "oneway", "disk", "crash", "membership", "overload")
    dims += ("modeflip",) if backend == "tpu_batch" else ()
    for dim in dims:
        assert res.nemesis.get(f"nemesis_{dim}_injected", 0) > 0, (dim, res.nemesis)
    injected = sum(v for k, v in res.nemesis.items() if k.endswith("_injected"))
    assert len([s for s in res.schedule if s[2] == "inject"]) == injected
