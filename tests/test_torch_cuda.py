"""The port on a CUDA card: the quorum kernel against its plain version,
the fused step on the card against the same step on the CPU, and a small
3-coordinator cluster committing through the kernel. Every test skips
without a card (the kernels have no CPU mode). Run on a GPU machine from
the repository root; the file imports no JAX, so it also runs where JAX
is not installed:

    python3 -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from ra_tpu_torch.ops import consensus as C
from ra_tpu_torch.ops import quorum as Q

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

        launches = Q.LAUNCHES
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
        assert Q.LAUNCHES > launches
    finally:
        for c in coords:
            c.stop()
