"""The port on a CUDA card: the quorum kernel against its plain version,
the step kernels (full width and active set) against the plain torch-op
step on the card and on the CPU over the edge inputs of
``torch_step_cases``, a small 3-coordinator cluster committing
through the step kernels, three started coordinators serving the
client API (``ra_tpu_torch.api``) through them, and the fault-injection
harness and the linearizability workload with their coordinators on the
card. Every test skips without a card (the kernels
have no CPU mode). Run on a GPU machine from the repository root; the
file imports no JAX, so it also runs where JAX is not installed:

    python3 -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import time

import numpy as np
import pytest
import torch

from ra_tpu_torch.ops import consensus as C
from ra_tpu_torch.ops import quorum as Q
from ra_tpu_torch.ops import step as S

import torch_step_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _quorum_inputs(rng, g, p):
    match = rng.integers(0, 1 << 20, (g, p)).astype(np.int32)
    voting = rng.random((g, p)) < 0.7
    voting[::3] = False
    voting[1::3] = True
    nvoters = voting.sum(axis=1).astype(np.int32)
    return match, voting, nvoters


@pytest.mark.parametrize("p", list(range(1, 9)))
def test_kernel_matches_plain_on_the_card(dev, p):
    rng = np.random.default_rng(p)
    args = [torch.from_numpy(a).to(dev) for a in _quorum_inputs(rng, 1001, p)]
    launches = Q.LAUNCHES
    got = Q.agreed_commit(*args)
    assert Q.LAUNCHES == launches + 1
    assert torch.equal(got, Q.agreed_commit_plain(*args))


def test_fused_step_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(3)
    g, p, k = 512, 3, 16
    st = C.make_group_state(g, p, k, device="cpu")
    last = rng.integers(0, 10, g).astype(np.int32)
    fields = C.state_to_numpy(st)
    fields.update(
        role=np.full(g, C.R_LEADER, np.int32),
        current_term=np.ones(g, np.int32),
        last_index=last, last_term=np.ones(g, np.int32),
        written_index=last, term_suffix=np.ones((g, k), np.int32),
        match_index=np.minimum(rng.integers(0, 10, (g, p)), last[:, None]).astype(np.int32),
        voting=np.ones((g, p), bool), active=np.ones((g, p), bool),
    )
    cpu = C.state_from_numpy(fields, "cpu")
    card = C.state_from_numpy(fields, dev)
    packed = np.zeros((len(C.MBOX_FIELDS) + len(C.MBOX_SCAT_FIELDS), g), np.int32)
    R = {f: i for i, f in enumerate(C.MBOX_FIELDS + C.MBOX_SCAT_FIELDS)}
    packed[R["host_term_idx"]] = -1
    packed[R["host_term_val"]] = -1
    packed[R["msg_type"]] = C.MSG_AER_REPLY
    packed[R["sender_slot"]] = rng.integers(0, p, g)
    packed[R["term"]] = 1
    packed[R["success"]] = 1
    packed[R["reply_last_idx"]] = last
    packed[R["a_gid"]] = g
    packed[R["w_gid"]] = g
    cpu2, eg_cpu = C.consensus_step_packed_scat(cpu, torch.from_numpy(packed))
    card2, eg_card = C.consensus_step_packed_scat(card, torch.from_numpy(packed).to(dev))
    assert torch.equal(eg_card.cpu(), eg_cpu)
    a, b = C.state_to_numpy(card2), C.state_to_numpy(cpu2)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert (b["commit_index"] > 0).any()


def _assert_same(st_a, eg_a, st_b, eg_b, where):
    eg_a, eg_b = eg_a.cpu(), eg_b.cpu()
    bad = [f for r, f in enumerate(C.EGRESS_FIELDS)
           if not torch.equal(eg_a[r], eg_b[r])]
    assert not bad, f"{where}: egress rows differ: {bad}"
    a, b = C.state_to_numpy(st_a), C.state_to_numpy(st_b)
    bad = [f for f in a if not np.array_equal(a[f], b[f])]
    assert not bad, f"{where}: state fields differ: {bad}"


@pytest.mark.parametrize("near_max", [False, True])
@pytest.mark.parametrize("p", list(range(1, 17)) + [33])
def test_step_kernels_match_the_plain_step(dev, p, near_max):
    """Full width and active set, K in {8, 32}, at the peer widths with
    register instances (1..8) and of the runtime-width instance (9..16,
    33): the kernel on the card
    equals the plain step on the card and on the CPU, in every state
    field and egress row, over the edge inputs; the quorum kernel is
    not launched on the kernel path."""
    g = 1000
    for k in (8, 32):
        rng = np.random.default_rng(100 * p + k + near_max)
        f = cases.state_fields(rng, g, p, k, near_max=near_max)
        cpu, card = C.state_from_numpy(f, "cpu"), C.state_from_numpy(f, dev)
        packed = cases.packed(rng, f, np.arange(g), g)
        gidx = cases.active_set(rng, g, 300, 512)
        sub = cases.packed(rng, f, gidx, 512)
        runs = (
            ("full", (packed,), C.consensus_step_packed_scat,
             C.consensus_step_packed_scat_plain),
            ("sub", (sub, gidx), C.consensus_step_packed_sub_scat,
             C.consensus_step_packed_sub_scat_plain),
        )
        for kind, args, kernel_fn, plain_fn in runs:
            host = [torch.from_numpy(a) for a in args]
            on_card = [a.to(dev) for a in host]
            counts = (S.LAUNCHES_FULL, S.LAUNCHES_SUB, Q.LAUNCHES)
            got = kernel_fn(card, *on_card)
            torch.cuda.synchronize()
            want = (1, 0) if kind == "full" else (0, 1)
            assert (S.LAUNCHES_FULL - counts[0], S.LAUNCHES_SUB - counts[1],
                    Q.LAUNCHES - counts[2]) == want + (0,)
            where = f"{kind} p={p} k={k} near_max={near_max}"
            _assert_same(*got, *plain_fn(card, *on_card), where + " card")
            _assert_same(*got, *plain_fn(cpu, *host), where + " cpu")
            # the input state is untouched: nothing is updated in place
            kept = C.state_to_numpy(card)
            assert all(np.array_equal(kept[n], f[n]) for n in f), where


def test_step_kernel_refuses_what_it_cannot_take(dev):
    rng = np.random.default_rng(5)
    f = cases.state_fields(rng, 64, 3, 8)
    card = C.state_from_numpy(f, dev)
    packed = torch.from_numpy(cases.packed(rng, f, np.arange(64), 64))
    with pytest.raises(ValueError):  # mailbox left on the host
        C.consensus_step_packed_scat(card, packed)
    with pytest.raises(ValueError):  # a strided mailbox
        wide = torch.zeros((24, 128), dtype=torch.int32, device=dev)
        C.consensus_step_packed_scat(card, wide[:, ::2])


def test_three_coordinators_commit_through_the_kernel(dev):
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.protocol import USR, Command, ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n = 64
    coords = [BatchCoordinator(f"cu{i}", capacity=g_n, num_peers=3,
                               idle_sleep_s=0, device=dev) for i in range(3)]
    try:
        for c in coords:
            c.add_groups([
                (f"g{g}", f"cucl{g}", [(f"g{g}", f"cu{i}") for i in range(3)],
                 SimpleMachine(lambda cmd, s: s + cmd, 0), None)
                for g in range(g_n)
            ])

        def step():
            worked = False
            for c in coords:
                worked = c.step_stage() or worked
            for c in coords:
                worked = c.step_finish() or worked
            return worked

        launches = S.LAUNCHES_FULL + S.LAUNCHES_SUB
        coords[0].deliver_many(
            [((f"g{g}", "cu0"), ElectionTimeout(), None) for g in range(g_n)])
        for _ in range(200):
            step()
            if all(coords[0].by_name[f"g{g}"].role == C.R_LEADER
                   for g in range(g_n)):
                break
        for g in range(g_n):
            coords[0].deliver((f"g{g}", "cu0"),
                              Command(kind=USR, data=g, reply_mode="noreply"), None)
        for _ in range(200):
            if not step() and all(
                c.by_name[f"g{g}"].machine_state == g
                for c in coords for g in range(g_n)
            ):
                break
        for c in coords:
            assert [c.by_name[f"g{g}"].machine_state for g in range(g_n)] == list(range(g_n))
            assert c.state.commit_index.device.type == "cuda"
        assert S.LAUNCHES_FULL + S.LAUNCHES_SUB > launches
    finally:
        for c in coords:
            c.stop()


def test_api_drives_started_coordinators_through_the_kernel(dev, tmp_path):
    """Three started coordinators (own step threads) on the card, with
    WAL-backed logs and leases, serve ``ra_tpu_torch.api``: every reply
    and consistent read is the group's sum, replicas agree, and the
    step kernels launched while quorum.cu did not."""
    import os

    from ra_tpu_torch import api, leaderboard
    from ra_tpu_torch.log.log import Log
    from ra_tpu_torch.log.segment_writer import SegmentWriter
    from ra_tpu_torch.log.tables import TableRegistry
    from ra_tpu_torch.log.wal import Wal
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.protocol import ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n = 48
    names = [f"ca{i}" for i in range(3)]
    leaderboard.clear()
    coords = [BatchCoordinator(n, capacity=g_n, num_peers=3, device=dev,
                               lease=True) for n in names]
    storage = []
    try:
        for n, c in zip(names, coords):
            d = str(tmp_path / n)
            tables = TableRegistry()
            sw = SegmentWriter(os.path.join(d, "data"), tables, c.wal_notify)
            wal = Wal(os.path.join(d, "wal"), tables, c.wal_notify,
                      segment_writer=sw)
            wal.notify_many = c.wal_notify_many
            storage.append((wal, sw))
            c.add_groups([
                (f"g{g}", f"cacl{g}", [(f"g{g}", m) for m in names],
                 SimpleMachine(lambda cmd, s: s + cmd, 0),
                 Log(f"g{g}", os.path.join(d, "data", f"g{g}"), tables, wal))
                for g in range(g_n)
            ])
        launches = (S.LAUNCHES_FULL + S.LAUNCHES_SUB, Q.LAUNCHES)
        for c in coords:
            c.start()
        coords[0].deliver_many(
            [((f"g{g}", "ca0"), ElectionTimeout(), None) for g in range(g_n)])
        for g in range(g_n):
            sid = (f"g{g}", names[g % 3])
            assert api.process_command(sid, g, timeout=30)[0] == g
            assert api.process_command(sid, 1, timeout=30)[0] == g + 1
            out = api.consistent_query((f"g{g}", names[(g + 1) % 3]),
                                       lambda s: s, timeout=30)
            assert out[:2] == ("ok", g + 1)
        for g in range(g_n):
            for n in names:
                for _ in range(300):
                    if api.local_query((f"g{g}", n), lambda s: s)[1] == g + 1:
                        break
                    time.sleep(0.02)
                assert api.local_query((f"g{g}", n), lambda s: s)[1] == g + 1
        for c in coords:
            assert c.state.commit_index.device.type == "cuda"
        assert S.LAUNCHES_FULL + S.LAUNCHES_SUB > launches[0]
        assert Q.LAUNCHES == launches[1]
    finally:
        for c in reversed(coords):  # followers first, then the leader
            c.stop()
        for wal, sw in storage:
            wal.close()
            sw.close()
        leaderboard.clear()


def test_harness_runs_the_batch_backend_on_the_card(dev):
    """The combined-fault harness run of ``tests/test_soak.py`` (seed 2,
    every nemesis dimension, a coordinator crash-restart from the WAL
    and live active-set mode flips) with the coordinators on the card,
    then the live linearizability workload: consistent, linearizable,
    and through the step kernels only."""
    from ra_tpu_torch import kv_harness, linearize

    launches = (S.LAUNCHES_FULL + S.LAUNCHES_SUB, Q.LAUNCHES)
    res = kv_harness.run(seed=2, n_ops=60, backend="tpu_batch",
                         combined=True, device=dev)
    assert res.consistent, res.failures
    assert res.ops.get("coord_restart", 0) > 0
    assert res.nemesis.get("nemesis_modeflip_injected", 0) > 0
    lin = linearize.run_workload(seed=9, backend="tpu_batch", n_clients=4,
                                 ops_per_client=30, device=dev)
    assert lin.ok, lin.violations
    assert S.LAUNCHES_FULL + S.LAUNCHES_SUB > launches[0]
    assert Q.LAUNCHES == launches[1]
