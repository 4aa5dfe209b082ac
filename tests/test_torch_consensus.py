"""Parity: ``ra_tpu_torch.ops.consensus`` against ``ra_tpu.ops.consensus``.

One seeded state and mailbox go through the JAX function and its port
(on the CPU, where the port's quorum wrapper runs its plain version);
every state field and every egress row must be equal, exactly. Covers
term_at, the AER / vote / pre-vote decisions, the quorum scan, leader
replies and the election progression, every record_* helper (with pad
and duplicate gids), force_elections and set_roles, the four packed
steps, and a seeded lockstep fuzz against the JAX step."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ra_tpu.ops import consensus as J
from ra_tpu_torch.ops import consensus as T

from test_consensus_kernels import K, PEERS, G, random_state
from test_fuzz_conformance import random_mailbox, snap
from torch_parity import (
    assert_egress_equal,
    assert_state_equal,
    jax_copy,
    mailbox_to_torch,
    to_torch,
)


def _t(a, dtype=np.int32):
    return torch.from_numpy(np.asarray(a, dtype))


def _both_step(jst, mb):
    """(JAX result, port result) of one consensus_step on the same
    inputs."""
    tst = to_torch(jst)
    j_out = J.consensus_step(jax_copy(jst), mb)
    t_out = T.consensus_step(tst, mailbox_to_torch(mb))
    return j_out, t_out


def test_constants_and_layouts_match_the_reference():
    for name in ("MSG_NONE", "MSG_AER", "MSG_AER_REPLY", "MSG_VOTE_REQ",
                 "MSG_VOTE_REPLY", "MSG_PREVOTE_REQ", "MSG_PREVOTE_REPLY",
                 "R_FOLLOWER", "R_PRE_VOTE", "R_CANDIDATE", "R_LEADER",
                 "AER_STALE", "AER_OK", "AER_MISMATCH", "AER_BEHIND_SNAPSHOT"):
        assert getattr(T, name) == getattr(J, name), name
    assert T.MBOX_FIELDS == J.MBOX_FIELDS
    assert T.EGRESS_FIELDS == J.EGRESS_FIELDS
    assert T.MBOX_SCAT_FIELDS == J.MBOX_SCAT_FIELDS
    assert T.GroupState._fields == J.GroupState._fields
    assert T.Mailbox._fields == J.Mailbox._fields
    assert T.Egress._fields == J.Egress._fields


def test_fresh_state_and_mailbox_match():
    assert_state_equal(J.make_group_state(7, 3, 8),
                       T.make_group_state(7, 3, 8, device="cpu"))
    jm, tm = J.empty_mailbox(7), T.empty_mailbox(7, device="cpu")
    for k, v in jm._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), getattr(tm, k).numpy())
        assert getattr(tm, k).dtype == (torch.bool if k == "success" else torch.int32)


def test_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_group_state(4, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.empty_mailbox(4)


def test_state_numpy_round_trip():
    st = random_state(np.random.default_rng(3))
    back = T.state_to_numpy(to_torch(st))
    for k, v in st._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), back[k])
    bad = {k: np.asarray(v) for k, v in st._asdict().items()}
    bad["role"] = bad["role"].astype(np.int64)
    with pytest.raises(TypeError):
        T.state_from_numpy(bad, "cpu")


def test_term_at_matches():
    rng = np.random.default_rng(11)
    st = random_state(rng)
    tst = to_torch(st)
    for _ in range(4):
        idx = rng.integers(-3, 60, G).astype(np.int32)
        jt, jk = J.term_at(st, jnp.asarray(idx))
        tt, tk = T.term_at(tst, _t(idx))
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())


@pytest.mark.parametrize("kind", ["aer", "vote", "prevote", "aer_reply",
                                  "vote_reply", "prevote_reply", "mixed"])
def test_decision_parity(kind):
    """AER accept, vote and pre-vote grants and the reply paths: the
    same random state and mailbox give the same state and egress."""
    types = {
        "aer": J.MSG_AER, "vote": J.MSG_VOTE_REQ,
        "prevote": J.MSG_PREVOTE_REQ, "aer_reply": J.MSG_AER_REPLY,
        "vote_reply": J.MSG_VOTE_REPLY, "prevote_reply": J.MSG_PREVOTE_REPLY,
    }
    rng = np.random.default_rng(100 + len(kind))
    st = random_state(rng, g=256, p=5)
    for _ in range(3):
        mb, mtypes = random_mailbox(rng, snap(st))
        if kind != "mixed":
            mt = np.where(mtypes != J.MSG_NONE, types[kind], J.MSG_NONE)
            mb = mb._replace(msg_type=jnp.asarray(mt.astype(np.int32)))
        (js, je), (ts, te) = _both_step(st, mb)
        assert_state_equal(js, ts, kind)
        assert_egress_equal(je, te, kind)
        st = js


@pytest.mark.parametrize("backend", ["kernel", "sort"])
def test_quorum_scan_parity(backend):
    rng = np.random.default_rng(4)
    st = random_state(rng)._replace(role=jnp.full((G,), J.R_LEADER, jnp.int32))
    try:
        T.configure(quorum_backend=backend)
        (js, je), (ts, te) = _both_step(st, J.empty_mailbox(G))
    finally:
        T.configure(quorum_backend="kernel")
    assert_state_equal(js, ts)
    assert_egress_equal(je, te)
    assert (np.asarray(js.commit_index) > np.asarray(st.commit_index)).any()


def test_leader_aer_reply_updates_match_and_commit():
    st = J.make_group_state(4, 3, K)
    st = st._replace(
        role=jnp.asarray([J.R_LEADER, 0, 0, 0], jnp.int32),
        current_term=jnp.asarray([2, 0, 0, 0], jnp.int32),
        last_index=jnp.asarray([3, 0, 0, 0], jnp.int32),
        last_term=jnp.asarray([2, 0, 0, 0], jnp.int32),
        written_index=jnp.asarray([3, 0, 0, 0], jnp.int32),
        term_suffix=st.term_suffix.at[0, jnp.asarray([1, 2, 3]) % K].set(2),
    )
    mb = J.empty_mailbox(4)._replace(
        msg_type=jnp.asarray([J.MSG_AER_REPLY, 0, 0, 0], jnp.int32),
        sender_slot=jnp.asarray([1, 0, 0, 0], jnp.int32),
        term=jnp.asarray([2, 0, 0, 0], jnp.int32),
        success=jnp.asarray([True, False, False, False]),
        reply_last_idx=jnp.asarray([3, 0, 0, 0], jnp.int32),
        reply_next_idx=jnp.asarray([4, 0, 0, 0], jnp.int32),
    )
    (js, je), (ts, te) = _both_step(st, mb)
    assert_state_equal(js, ts)
    assert_egress_equal(je, te)
    assert int(ts.commit_index[0]) == 3 and int(ts.match_index[0, 1]) == 3


def test_election_progression_prevote_candidate_leader():
    st = J.make_group_state(1, 3, K)._replace(role=jnp.asarray([1], jnp.int32))
    mb1 = J.empty_mailbox(1)._replace(
        msg_type=jnp.asarray([J.MSG_PREVOTE_REPLY], jnp.int32),
        sender_slot=jnp.asarray([1], jnp.int32),
        success=jnp.asarray([True]),
    )
    mb2 = J.empty_mailbox(1)._replace(
        msg_type=jnp.asarray([J.MSG_VOTE_REPLY], jnp.int32),
        sender_slot=jnp.asarray([2], jnp.int32),
        term=jnp.asarray([1], jnp.int32),
        success=jnp.asarray([True]),
    )
    for mb in (mb1, mb2):
        (js, je), (ts, te) = _both_step(st, mb)
        assert_state_equal(js, ts)
        assert_egress_equal(je, te)
        st = js
    assert int(ts.role[0]) == T.R_LEADER and int(ts.leader_slot[0]) == 0


def _pad_and_dup_ids(g):
    # a duplicate gid, pads at and beyond capacity, and a negative id
    # (JAX wraps it once, as numpy does)
    return np.asarray([1, 5, 1, g, g + 7, -1, 2], np.int32)


def test_record_appended_with_pads_duplicates_and_long_runs():
    rng = np.random.default_rng(21)
    st = random_state(rng, g=16, p=3, k=8)
    # group 3: one in-order run longer than K (idx i and i + 8 share a
    # slot; the later entry must win), group 4: two entries, pads
    gids = [3] * 12 + [4, 4, 16, 16, -1]
    idxs = list(range(20, 32)) + [30, 31, 5, 6, 40]
    terms = [2] * 6 + [3] * 6 + [4, 4, 9, 9, 5]
    args = [np.asarray(a, np.int32) for a in (gids, idxs, terms)]
    js = J.record_appended(st, *(jnp.asarray(a) for a in args))
    ts = T.record_appended(to_torch(st), *(_t(a) for a in args))
    assert_state_equal(js, ts)


def test_record_appended_runs_written_snapshot_with_pads():
    rng = np.random.default_rng(22)
    st = random_state(rng, g=16, p=3, k=8)
    tst = to_torch(st)
    gids = np.asarray([2, 7, 16, 16, 9, -1], np.int32)  # unique + pads
    los = np.asarray([3, 10, 1, 1, 30, 4], np.int32)
    his = np.asarray([14, 12, 2, 2, 31, 6], np.int32)
    terms = np.asarray([5, 6, 1, 1, 7, 8], np.int32)
    js = J.record_appended_runs(st, *(jnp.asarray(a) for a in (gids, los, his, terms)))
    ts = T.record_appended_runs(tst, *(_t(a) for a in (gids, los, his, terms)))
    assert_state_equal(js, ts, "record_appended_runs")

    ids = _pad_and_dup_ids(16)
    w = np.asarray([9, 40, 50, 3, 3, 44, 1], np.int32)
    assert_state_equal(J.record_written(st, jnp.asarray(ids), jnp.asarray(w)),
                       T.record_written(tst, _t(ids), _t(w)), "record_written")

    sg = np.asarray([4, 16, 11, -2], np.int32)
    si = np.asarray([25, 1, 3, 9], np.int32)
    stm = np.asarray([4, 1, 2, 6], np.int32)
    assert_state_equal(
        J.record_snapshot(st, *(jnp.asarray(a) for a in (sg, si, stm))),
        T.record_snapshot(tst, *(_t(a) for a in (sg, si, stm))),
        "record_snapshot",
    )


def test_force_elections_and_set_roles_with_pads_and_duplicates():
    rng = np.random.default_rng(23)
    st = random_state(rng, g=16, p=3, k=8)
    tst = to_torch(st)
    ids = _pad_and_dup_ids(16)
    assert_state_equal(J.force_elections(st, jnp.asarray(ids)),
                       T.force_elections(tst, _t(ids)), "force_elections")
    # a duplicate gid with the same role: the pre-vote token adds twice
    roles = np.asarray([J.R_PRE_VOTE, J.R_CANDIDATE, J.R_PRE_VOTE, 0, 1, 2, 3],
                       np.int32)
    assert_state_equal(J.set_roles(st, jnp.asarray(ids), jnp.asarray(roles)),
                       T.set_roles(tst, _t(ids), _t(roles)), "set_roles")


def _packed_mailbox(rng, st, cols, width, g):
    """A packed mailbox + fused scatter rows addressing ``cols``."""
    mb, _ = random_mailbox(rng, snap(st))
    n = len(cols)
    rows = np.zeros((len(J.MBOX_FIELDS) + len(J.MBOX_SCAT_FIELDS), width), np.int32)
    full = np.stack([np.asarray(getattr(mb, f)).astype(np.int32)
                     for f in J.MBOX_FIELDS])
    rows[: len(J.MBOX_FIELDS), :n] = full[:, cols]
    R = {f: i for i, f in enumerate(J.MBOX_FIELDS + J.MBOX_SCAT_FIELDS)}
    rows[R["host_term_idx"], n:] = -1
    rows[R["host_term_val"], n:] = -1
    rows[R["a_gid"]] = g
    rows[R["w_gid"]] = g
    na = max(1, n // 3)
    ag = rng.choice(cols, size=na, replace=False)
    last = np.asarray(st.last_index)[ag]
    rows[R["a_gid"], :na] = ag
    rows[R["a_hi"], :na] = last + rng.integers(0, 3, na)
    rows[R["a_lo"], :na] = np.maximum(rows[R["a_hi"], :na] - rng.integers(0, 20, na), 1)
    rows[R["a_term"], :na] = np.asarray(st.current_term)[ag]
    wg = rng.choice(cols, size=na, replace=False)
    rows[R["w_gid"], :na] = wg
    rows[R["w_idx"], :na] = np.asarray(st.last_index)[wg]
    return rows


@pytest.mark.parametrize("entry", ["packed", "packed_sub", "packed_scat",
                                   "packed_sub_scat"])
def test_packed_steps_match(entry):
    rng = np.random.default_rng(31 + len(entry))
    g = 256
    st = random_state(rng, g=g, p=PEERS)
    for _ in range(3):
        if "sub" in entry:
            n, cap = 40, 64
            cols = np.sort(rng.choice(g, size=n, replace=False))
            rows = _packed_mailbox(rng, st, cols, cap, g)
            gidx = np.full(cap, g, np.int32)
            gidx[:n] = cols
            gidx[n] = g + 3  # pads beyond capacity clamp on the gather
        else:
            rows = _packed_mailbox(rng, st, np.arange(g), g, g)
        if "scat" not in entry:
            rows = rows[: len(J.MBOX_FIELDS)]
        jf = getattr(J, f"consensus_step_{entry}")
        tf = getattr(T, f"consensus_step_{entry}")
        tst = to_torch(st)
        if "sub" in entry:
            js, je = jf(jax_copy(st), jnp.asarray(rows), jnp.asarray(gidx))
            ts, te = tf(tst, _t(rows), _t(gidx))
        else:
            js, je = jf(jax_copy(st), jnp.asarray(rows))
            ts, te = tf(tst, _t(rows))
        np.testing.assert_array_equal(np.asarray(je), te.numpy())
        assert_state_equal(js, ts, entry)
        st = js


def test_sub_step_matches_full_step():
    """The port's active-set path against its own full-width path, as
    the reference's test_active_set checks its kernels."""
    g, p = 32, 3
    li = (np.arange(g) % 7).astype(np.int32)
    base = T.make_group_state(g, p, device="cpu")
    base = base._replace(last_index=_t(li), written_index=_t(li))
    act = [3, 11, 17]
    Rm = {name: i for i, name in enumerate(T.MBOX_FIELDS)}
    full = np.zeros((len(T.MBOX_FIELDS), g), np.int32)
    sub = np.zeros((len(T.MBOX_FIELDS), 4), np.int32)
    for arr in (full, sub):
        arr[Rm["host_term_idx"]] = -1
        arr[Rm["host_term_val"]] = -1
    for pi, gi in enumerate(act):
        for arr, col in ((full, gi), (sub, pi)):
            arr[Rm["msg_type"], col] = T.MSG_AER
            arr[Rm["term"], col] = 1
            arr[Rm["prev_idx"], col] = li[gi]
            arr[Rm["num_entries"], col] = 2
            arr[Rm["entries_last_term"], col] = 1
            arr[Rm["leader_commit"], col] = li[gi] + 2
    gidx = np.full(4, g, np.int32)
    gidx[:3] = act
    a, ea = T.consensus_step_packed(base, _t(full))
    b, eb = T.consensus_step_packed_sub(base, _t(sub), _t(gidx))
    for pi, gi in enumerate(act):
        np.testing.assert_array_equal(ea[:, gi].numpy(), eb[:, pi].numpy())
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.numpy(), fb.numpy())
    # the input state is untouched: the port never updates in place
    np.testing.assert_array_equal(base.last_index.numpy(), li)


def test_seeded_lockstep_fuzz_zero_divergence():
    """Modelled on test_fuzz_conformance: every step feeds every group a
    random-but-plausible message; the JAX step and the port step run in
    lockstep, with the host reconciliation (record_appended +
    record_written) after each, and must never diverge in any state
    field or egress row."""
    rng = np.random.default_rng(20260729)
    st = random_state(rng, g=G, p=PEERS)._replace(role=jnp.zeros((G,), jnp.int32))
    tst = to_torch(st)
    consumed = 0
    for step in range(60):
        mb, mtypes = random_mailbox(rng, snap(st))
        consumed += int((mtypes != J.MSG_NONE).sum())
        st, jeg = J.consensus_step(st, mb)
        tst, teg = T.consensus_step(tst, mailbox_to_torch(mb))
        assert_egress_equal(jeg, teg, f"step {step}")
        assert_state_equal(st, tst, f"step {step}")
        m = {n: np.asarray(getattr(mb, n)) for n in J.MBOX_FIELDS}
        acc = np.flatnonzero(
            (np.asarray(jeg.aer_code) == J.AER_OK) & (m["num_entries"] > 0)
            & (mtypes == J.MSG_AER)
        )
        if len(acc):
            trip = np.asarray([
                (i, idx, m["entries_last_term"][i])
                for i in acc
                for idx in range(m["prev_idx"][i] + 1,
                                 m["prev_idx"][i] + m["num_entries"][i] + 1)
            ], np.int32)
            st = J.record_appended(st, *(jnp.asarray(trip[:, c]) for c in range(3)))
            tst = T.record_appended(tst, *(_t(trip[:, c]) for c in range(3)))
            idxs = (m["prev_idx"][acc] + m["num_entries"][acc]).astype(np.int32)
            st = J.record_written(st, jnp.asarray(acc.astype(np.int32)), jnp.asarray(idxs))
            tst = T.record_written(tst, _t(acc), _t(idxs))
            assert_state_equal(st, tst, f"record step {step}")
    assert consumed >= 14_000, consumed
