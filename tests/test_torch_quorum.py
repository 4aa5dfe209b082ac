"""The port's quorum scan (``ra_tpu_torch.ops.quorum``) against the JAX
package's Pallas kernel (interpret mode on the CPU), its sort formulation
and the scalar oracle; the kernel itself runs only on a CUDA card."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ra_tpu.ops import consensus as J
from ra_tpu.ops import decisions as dec
from ra_tpu.ops.pallas_quorum import agreed_commit_pallas
from ra_tpu_torch.ops import consensus as T
from ra_tpu_torch.ops import quorum as Q

from torch_parity import assert_egress_equal, assert_state_equal, jax_copy, to_torch


def _inputs(seed, p, g=300):
    rng = np.random.default_rng(seed)
    match = rng.integers(0, 1000, (g, p)).astype(np.int32)
    voting = rng.random((g, p)) < 0.8
    voting[:, 0] = True  # at least one voter per group
    nvoters = voting.sum(axis=1).astype(np.int32)
    return match, voting, nvoters


def _port(match, voting, nvoters):
    return Q.agreed_commit(
        torch.from_numpy(match), torch.from_numpy(voting),
        torch.from_numpy(nvoters),
    ).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [3, 5, 7])
def test_port_matches_pallas_sort_and_oracle(seed, p):
    match, voting, nvoters = _inputs(seed, p)
    launches = Q.LAUNCHES
    got = _port(match, voting, nvoters)
    assert Q.LAUNCHES == launches  # CPU tensors never launch the kernel
    jm, jv, jn = jnp.asarray(match), jnp.asarray(voting), jnp.asarray(nvoters)
    pallas = np.asarray(agreed_commit_pallas(jm, jv, jn, interpret=True))
    sort = np.asarray(J.agreed_commit_sort(jm, jv, jn))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, sort)
    for i in range(match.shape[0]):
        voters = [int(match[i, s]) for s in range(p) if voting[i, s]]
        assert got[i] == dec.agreed_commit(voters), (i, voters)


def test_full_single_and_no_voter_edges():
    match = np.asarray([[5, 9, 7], [3, 0, 0], [4, 8, 6]], np.int32)
    voting = np.asarray([[True, True, True], [True, False, False],
                         [False, False, False]])
    nvoters = voting.sum(axis=1).astype(np.int32)
    got = _port(match, voting, nvoters)
    pallas = np.asarray(agreed_commit_pallas(
        jnp.asarray(match), jnp.asarray(voting), jnp.asarray(nvoters),
        interpret=True,
    ))
    np.testing.assert_array_equal(got, pallas)
    assert got[0] == 7  # median of {5, 9, 7}
    assert got[1] == 3  # a single voter's own match
    assert got[2] == -1  # no voter


@pytest.mark.parametrize("p", [1, 2, 4, 6, 8])
def test_every_kernel_width_matches_sort(p):
    match, voting, nvoters = _inputs(10 + p, p, g=257)
    voting[::5] = False  # rows with no voter
    nvoters = voting.sum(axis=1).astype(np.int32)
    got = _port(match, voting, nvoters)
    want = np.asarray(J.agreed_commit_sort(
        jnp.asarray(match), jnp.asarray(voting), jnp.asarray(nvoters)))
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    m = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.ones((4, 3), dtype=torch.bool)
    n = torch.full((4,), 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        Q.agreed_commit(torch.zeros((4, 9), dtype=torch.int32),
                        torch.ones((4, 9), dtype=torch.bool), n)
    with pytest.raises(TypeError):
        Q.agreed_commit(m.long(), v, n)
    with pytest.raises(ValueError):
        Q.agreed_commit(m, v[:3], n)
    with pytest.raises(ValueError):
        Q.agreed_commit(torch.zeros((3, 4), dtype=torch.int32).t(), v, n)


def test_full_step_with_kernel_backend_matches_pallas_backend():
    """The whole fused step with the port's default (kernel) quorum
    backend equals the JAX step with its Pallas backend, field by field;
    ``configure(quorum_backend="sort")`` gives the same result."""
    rng = np.random.default_rng(5)
    g = 64
    st = J.make_group_state(g, 3)
    st = st._replace(
        role=jnp.full((g,), J.R_LEADER, jnp.int32),
        current_term=jnp.ones((g,), jnp.int32),
        written_index=jnp.asarray(rng.integers(0, 10, g), jnp.int32),
        match_index=jnp.asarray(rng.integers(0, 10, (g, 3)), jnp.int32),
        last_index=jnp.full((g,), 10, jnp.int32),
        last_term=jnp.ones((g,), jnp.int32),
        term_suffix=jnp.ones_like(st.term_suffix),
    )
    port_in = to_torch(st)
    try:
        J.configure(quorum_backend="pallas")
        j_st, j_eg = J.consensus_step(jax_copy(st), J.empty_mailbox(g))
    finally:
        J.configure(quorum_backend="sort")
    mb = T.empty_mailbox(g, device="cpu")
    t_st, t_eg = T.consensus_step(port_in, mb)
    assert_state_equal(j_st, t_st, "kernel backend")
    assert_egress_equal(j_eg, t_eg, "kernel backend")
    assert (np.asarray(j_st.commit_index) > 0).any()  # the scan advanced
    try:
        T.configure(quorum_backend="sort")
        s_st, s_eg = T.consensus_step(port_in, mb)
    finally:
        T.configure(quorum_backend="kernel")
    assert_state_equal(j_st, s_st, "sort backend")
    with pytest.raises(ValueError):
        T.configure(quorum_backend="pallas")


def test_wide_groups_take_the_sort_formulation_and_count_it():
    """P > 8 exceeds the kernel's register network: the step uses the
    sort formulation (the JAX package's own rule) and counts it."""
    st = J.make_group_state(8, 9)
    st = st._replace(role=jnp.full((8,), J.R_LEADER, jnp.int32),
                     written_index=jnp.full((8,), 3, jnp.int32))
    before = T.WIDE_SORT_STEPS
    t_st, _ = T.consensus_step(to_torch(st), T.empty_mailbox(8, device="cpu"))
    assert T.WIDE_SORT_STEPS == before + 1
    j_st, _ = J.consensus_step(jax_copy(st), J.empty_mailbox(8))
    assert_state_equal(j_st, t_st)
