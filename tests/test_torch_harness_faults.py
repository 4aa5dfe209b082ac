"""The harness's lease-read and storage-pressure dimensions on the port,
on the CPU.

``ra_tpu_torch.kv_harness.run`` on the batch backend (coordinators on
``device="cpu"``) at the tier-1 seeds of ``tests/test_kv_harness.py``,
with its op counts, timeouts and assertions: lease reads under one-way
partitions with forced depositions (seed 61) and ENOSPC storms that
must degrade and resume a coordinator (seed 11). The reference's slow
acceptance matrices for these dimensions run on the port as slow tests.
"""

import pytest
import torch

import ra_tpu_torch.kv_harness as port_harness

torch.set_num_threads(1)


def _device(backend):
    return {"device": "cpu"} if backend == "tpu_batch" else {}


def test_kv_harness_lease_reads_batch_on_port():
    res = port_harness.run(seed=61, n_ops=80, backend="tpu_batch",
                           lease=True, device="cpu")
    assert res.consistent, res.failures
    assert res.ops.get("get", 0) > 0
    assert res.ops.get("transfer", 0) > 0, "no depositions raced the reads"


def test_kv_harness_disk_full_batch_on_port():
    res = port_harness.run(seed=11, n_ops=100, backend="tpu_batch",
                           partitions=False, membership=False, restarts=False,
                           disk_full=True, op_timeout=3.0, device="cpu")
    assert res.consistent, res.failures
    assert res.ops.get("disk_full", 0) > 0, "no ENOSPC storms fired"
    assert res.ops.get("batch_degraded", 0) > 0, \
        "coordinator never entered degraded mode"
    assert res.ops.get("batch_resumed", 0) > 0, \
        "coordinator never resumed from degraded mode"


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["tpu_batch", "per_group_actor"])
@pytest.mark.parametrize("seed", [63, 64, 65])
def test_kv_harness_lease_reads_matrix_on_port(backend, seed):
    res = port_harness.run(seed=seed, n_ops=100, backend=backend, lease=True,
                           **_device(backend))
    assert res.consistent, res.failures
    assert res.ops.get("get", 0) > 0


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["tpu_batch", "per_group_actor"])
@pytest.mark.parametrize("seed", [71, 72, 73])
def test_kv_harness_disk_pressure_matrix_on_port(backend, seed):
    res = port_harness.run(seed=seed, n_ops=120, backend=backend,
                           partitions=False, membership=False,
                           disk_faults=True, disk_full=True, slow_disk=True,
                           op_timeout=5.0, **_device(backend))
    assert res.consistent, res.failures
