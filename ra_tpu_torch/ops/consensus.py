"""Vectorized consensus step over a raft-group batch axis, on torch tensors.

The PyTorch port of ``ra_tpu.ops.consensus``: per-group scalar state
lives on one device as int32/bool structure-of-arrays indexed by
group-id, and the three north-star decisions run as one step over *all*
groups at once:

- AppendEntries accept (term/prev-log matching) — mirrors
  ``decisions.aer_decision`` (reference behavior: src/ra_server.erl
  handle_follower :1283-1429);
- RequestVote / PreVote grant — mirrors ``decisions.vote_decision`` /
  ``decisions.pre_vote_decision`` (reference: :1489-1529, :2926-2984);
- match_index -> commit_index quorum scan — mirrors
  ``decisions.agreed_commit`` (reference: :3633-3688).

Log *contents* stay host-side; the device keeps a ring-buffer window of
recent entry terms (``term_suffix``, indexed by ``idx % K``) so prev-term
matching and commit-term gating run without host round-trips. Groups
whose lookup falls outside the window raise a ``needs_host`` flag and are
resolved by the scalar oracle on the host (rare: deep backfill).

Port notes:
- every function is a plain function on tensors, run eagerly; nothing is
  compiled. Every function RETURNS new tensors and updates no state
  tensor in place, so a holder of an earlier ``GroupState`` keeps valid,
  unchanging values (the JAX steps donate their state instead);
- JAX's index modes are reproduced explicitly, because torch raises (or,
  on the card, asserts) on an out-of-range index: negative ids wrap as
  in JAX, plain gathers clamp, ``mode="drop"`` scatters route
  out-of-range rows to a scratch row past the end, ``mode="fill"`` gets
  return the fill value. Nothing here syncs the host with the device;
- the quorum scan's default backend is the hand-written CUDA kernel
  (``ops.quorum``). On the TPU, XLA fused the ``jnp.sort`` formulation
  into the step; eager PyTorch offers no such fusion, so the sort costs
  several launches where the kernel costs one. On CPU tensors the
  wrapper runs the plain sort version. ``configure(quorum_backend=
  "sort")`` selects the plain sort formulation explicitly.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ra_tpu_torch.ops import quorum

# message type tags for the per-group mailbox
MSG_NONE = 0
MSG_AER = 1  # AppendEntries request (follower path)
MSG_AER_REPLY = 2  # AppendEntries reply (leader path)
MSG_VOTE_REQ = 3
MSG_VOTE_REPLY = 4
MSG_PREVOTE_REQ = 5
MSG_PREVOTE_REPLY = 6

# quorum-scan backend: "kernel" (ops.quorum.agreed_commit: the CUDA
# kernel on the card, its plain version on the CPU) or "sort" (the
# plain sort formulation everywhere)
_QUORUM_BACKEND = "kernel"

# steps whose peer width exceeded the kernel's MAX_P and so ran the sort
# formulation (the JAX package's own rule for its Pallas kernel)
WIDE_SORT_STEPS = 0


def configure(quorum_backend: Optional[str] = None) -> None:
    global _QUORUM_BACKEND
    if quorum_backend is not None:
        if quorum_backend not in ("kernel", "sort"):
            raise ValueError(f"unknown quorum_backend {quorum_backend!r}")
        _QUORUM_BACKEND = quorum_backend


# roles
R_FOLLOWER = 0
R_PRE_VOTE = 1
R_CANDIDATE = 2
R_LEADER = 3

# AER decision codes (must match ra_tpu_torch.ops.decisions)
AER_STALE = 0
AER_OK = 1
AER_MISMATCH = 2
AER_BEHIND_SNAPSHOT = 3

_I32 = torch.int32


class GroupState(NamedTuple):
    """Per-group consensus state, shape [G] or [G, P]. ``self_slot`` is
    this coordinator's slot in each group's member table."""

    current_term: torch.Tensor  # i32[G]
    voted_for: torch.Tensor  # i32[G], peer slot or -1
    commit_index: torch.Tensor  # i32[G]
    last_applied: torch.Tensor  # i32[G]
    last_index: torch.Tensor  # i32[G] last visible log index
    last_term: torch.Tensor  # i32[G]
    written_index: torch.Tensor  # i32[G] durable watermark
    snapshot_index: torch.Tensor  # i32[G]
    snapshot_term: torch.Tensor  # i32[G]
    role: torch.Tensor  # i32[G]
    leader_slot: torch.Tensor  # i32[G], -1 unknown
    self_slot: torch.Tensor  # i32[G]
    machine_version: torch.Tensor  # i32[G] effective machine version
    match_index: torch.Tensor  # i32[G, P]
    next_index: torch.Tensor  # i32[G, P]
    voting: torch.Tensor  # bool[G, P]
    active: torch.Tensor  # bool[G, P]
    votes: torch.Tensor  # bool[G, P]
    pre_votes: torch.Tensor  # bool[G, P]
    term_suffix: torch.Tensor  # i32[G, K] ring buffer of entry terms
    # inclusive interval of indexes whose ring slots are stale (multi-
    # entry accepts record only the tail term until the host reconciles
    # via record_appended); empty when lo > hi
    unknown_lo: torch.Tensor  # i32[G]
    unknown_hi: torch.Tensor  # i32[G]
    # pre-vote round counter (mirrors Server.pre_vote_token)
    pre_vote_token: torch.Tensor  # i32[G]


class Mailbox(NamedTuple):
    """At most one inbound message per group per step (dense)."""

    msg_type: torch.Tensor  # i32[G]
    sender_slot: torch.Tensor  # i32[G]
    term: torch.Tensor  # i32[G]
    # AER request fields
    prev_idx: torch.Tensor  # i32[G]
    prev_term: torch.Tensor  # i32[G]
    num_entries: torch.Tensor  # i32[G]
    entries_last_term: torch.Tensor  # i32[G] term of last entry in the batch
    leader_commit: torch.Tensor  # i32[G]
    # reply fields (AER reply) / vote fields
    success: torch.Tensor  # bool[G] (AER reply / vote granted)
    reply_next_idx: torch.Tensor  # i32[G]
    reply_last_idx: torch.Tensor  # i32[G]
    reply_last_term: torch.Tensor  # i32[G]
    cand_last_idx: torch.Tensor  # i32[G]
    cand_last_term: torch.Tensor  # i32[G]
    cand_machine_version: torch.Tensor  # i32[G]
    # host-resolved term cache (-1 = no override)
    host_term_idx: torch.Tensor  # i32[G]
    host_term_val: torch.Tensor  # i32[G]
    # pre-vote reply round token (must match state.pre_vote_token to count)
    token: torch.Tensor  # i32[G]


class Egress(NamedTuple):
    """Per-group outbound decision for the host to serialize."""

    send_reply: torch.Tensor  # bool[G] reply to sender?
    reply_type: torch.Tensor  # i32[G] echoes request type
    reply_to: torch.Tensor  # i32[G] sender slot
    term: torch.Tensor  # i32[G]
    success: torch.Tensor  # bool[G]
    next_index: torch.Tensor  # i32[G]
    last_index: torch.Tensor  # i32[G]
    last_term: torch.Tensor  # i32[G]
    aer_code: torch.Tensor  # i32[G] accept decision (write entries iff OK)
    became_leader: torch.Tensor  # bool[G]
    became_candidate: torch.Tensor  # bool[G]
    commit_advanced_to: torch.Tensor  # i32[G] new commit index (== old if not)
    needs_host: torch.Tensor  # bool[G] fall back to scalar oracle
    term_or_vote_changed: torch.Tensor  # bool[G] host must persist term/vote
    # post-step mirror for the host (role/leader/current term/agreed idx)
    role: torch.Tensor  # i32[G]
    leader_slot: torch.Tensor  # i32[G]
    agreed_idx: torch.Tensor  # i32[G] quorum match point (for host term lookup)
    voted_for: torch.Tensor  # i32[G] post-step vote (slot or -1) for persistence


def resolve_device(device=None) -> torch.device:
    """The explicit device of an entry point: ``None`` means ``"cuda"``,
    which raises when CUDA is absent. Only an explicit ``"cpu"`` runs on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def make_group_state(
    num_groups: int, num_peers: int, suffix_k: int = 32, device=None
) -> GroupState:
    g, p, k = num_groups, num_peers, suffix_k
    dev = resolve_device(device)
    zi = lambda *s: torch.zeros(s, dtype=_I32, device=dev)  # noqa: E731
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)  # noqa: E731
    return GroupState(
        current_term=zi(g),
        voted_for=torch.full((g,), -1, dtype=_I32, device=dev),
        commit_index=zi(g),
        last_applied=zi(g),
        last_index=zi(g),
        last_term=zi(g),
        written_index=zi(g),
        snapshot_index=zi(g),
        snapshot_term=zi(g),
        role=zi(g),
        leader_slot=torch.full((g,), -1, dtype=_I32, device=dev),
        self_slot=zi(g),
        machine_version=zi(g),
        match_index=zi(g, p),
        next_index=torch.ones((g, p), dtype=_I32, device=dev),
        voting=torch.ones((g, p), dtype=torch.bool, device=dev),
        active=torch.ones((g, p), dtype=torch.bool, device=dev),
        votes=zb(g, p),
        pre_votes=zb(g, p),
        term_suffix=zi(g, k),
        unknown_lo=torch.ones((g,), dtype=_I32, device=dev),
        unknown_hi=zi(g),
        pre_vote_token=zi(g),
    )


def empty_mailbox(num_groups: int, device=None) -> Mailbox:
    g = num_groups
    dev = resolve_device(device)
    zi = lambda: torch.zeros((g,), dtype=_I32, device=dev)  # noqa: E731
    return Mailbox(
        msg_type=zi(),
        sender_slot=zi(),
        term=zi(),
        prev_idx=zi(),
        prev_term=zi(),
        num_entries=zi(),
        entries_last_term=zi(),
        leader_commit=zi(),
        success=torch.zeros((g,), dtype=torch.bool, device=dev),
        reply_next_idx=zi(),
        reply_last_idx=zi(),
        reply_last_term=zi(),
        cand_last_idx=zi(),
        cand_last_term=zi(),
        cand_machine_version=zi(),
        host_term_idx=torch.full((g,), -1, dtype=_I32, device=dev),
        host_term_val=torch.full((g,), -1, dtype=_I32, device=dev),
        token=zi(),
    )


def state_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> GroupState:
    """A ``GroupState`` on ``device`` from numpy fields (for example the
    JAX package's state: ``{k: np.asarray(v) for k, v in
    st._asdict().items()}``)."""
    dev = resolve_device(device)
    out = {}
    for name in GroupState._fields:
        a = np.asarray(fields[name])
        want = np.bool_ if name in ("voting", "active", "votes", "pre_votes") else np.int32
        if a.dtype != want:
            raise TypeError(f"field {name}: dtype {a.dtype}, expected {np.dtype(want)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)
    return GroupState(**out)


def state_to_numpy(state: GroupState) -> dict:
    """Host numpy copies of every field, keyed by name."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


# ---------------------------------------------------------------------------
# JAX index modes, written out


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=like.device)


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ids with negatives wrapped once, as JAX normalises them."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` along axis 0 with JAX's gather semantics: negative
    ids wrap, out-of-range ids clamp."""
    n = arr.shape[0]
    return arr[_wrap(idx, n).clamp(0, n - 1)]


def _get_fill(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``arr.at[idx].get(mode="fill", fill_value=fill)`` along axis 0."""
    n = arr.shape[0]
    i = _wrap(idx, n)
    ok = (i >= 0) & (i < n)
    got = arr[i.clamp(0, n - 1)]
    if got.dim() > 1:
        ok = ok.view(-1, *([1] * (got.dim() - 1)))
    return torch.where(ok, got, fill)


def _drop_buffer(arr: torch.Tensor, idx: torch.Tensor):
    """A copy of ``arr`` with one scratch row appended, and ``idx`` with
    every out-of-range id routed to that row (``mode="drop"``)."""
    n = arr.shape[0]
    i = _wrap(idx, n)
    i = torch.where((i >= 0) & (i < n), i, n)
    buf = arr.new_empty((n + 1,) + tuple(arr.shape[1:]))
    buf[:n] = arr
    return buf, i


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` along axis 0 (ids must be
    unique among the in-range rows, as in JAX)."""
    buf, i = _drop_buffer(arr, idx)
    if not torch.is_tensor(vals):
        vals = torch.full(tuple(i.shape) + tuple(arr.shape[1:]), vals,
                          dtype=arr.dtype, device=arr.device)
    buf.index_put_((i,), vals.to(arr.dtype))
    return buf[: arr.shape[0]]


def scatter_max(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].max(vals, mode="drop")`` for a 1-D ``arr``;
    duplicate ids reduce order-independently."""
    buf, i = _drop_buffer(arr, idx)
    buf.scatter_reduce_(0, i, vals.to(arr.dtype), "amax", include_self=True)
    return buf[: arr.shape[0]]


def scatter_add(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].add(vals, mode="drop")`` for a 1-D ``arr``."""
    buf, i = _drop_buffer(arr, idx)
    buf.index_add_(0, i, vals.to(arr.dtype))
    return buf[: arr.shape[0]]


def _touched(like: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bool[G]: ``zeros.at[idx].set(True, mode="drop")``."""
    z = torch.zeros(like.shape[0], dtype=torch.bool, device=like.device)
    return scatter_set(z, idx, True)


def _at_col(arr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(arr, col[:, None], axis=-1)[:, 0]`` for an
    in-range ``col``."""
    return torch.gather(arr, -1, col.long()[:, None]).squeeze(-1)


# ---------------------------------------------------------------------------
# device-side term lookup


def agreed_commit_sort(
    match: torch.Tensor, voting: torch.Tensor, nvoters: torch.Tensor
) -> torch.Tensor:
    """Quorum scan, sort formulation (the plain version of the kernel)."""
    return quorum.agreed_commit_plain(match, voting, nvoters)


def term_at(state: GroupState, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(term, known) — term of the entry at ``idx`` from the ring-buffer
    window / snapshot boundary. known=False → host fallback needed."""
    k = state.term_suffix.shape[-1]
    in_window = (idx > torch.maximum(state.last_index - k, state.snapshot_index)) & (
        idx <= state.last_index
    )
    ring = _at_col(state.term_suffix, idx % k)
    is_snap = idx == state.snapshot_index
    is_zero = idx <= 0
    stale = (idx >= state.unknown_lo) & (idx <= state.unknown_hi)
    term = torch.where(is_zero, 0, torch.where(is_snap, state.snapshot_term, ring))
    known = is_zero | is_snap | (in_window & ~stale)
    return term.to(_I32), known


def _log_up_to_date(our_idx, our_term, cand_idx, cand_term):
    return (cand_term > our_term) | ((cand_term == our_term) & (cand_idx >= our_idx))


# ---------------------------------------------------------------------------
# the fused step


def consensus_step_impl(state: GroupState, mbox: Mailbox) -> Tuple[GroupState, Egress]:
    """One decision step over all groups: classify at most one inbound
    message per group, update consensus bookkeeping, run the quorum scan.
    Pure function of (state, mailbox) — host performs all I/O."""
    global WIDE_SORT_STEPS
    G, P = state.match_index.shape
    peers = _arange(P, state.match_index)[None, :]

    is_aer = mbox.msg_type == MSG_AER
    is_aer_reply = mbox.msg_type == MSG_AER_REPLY
    is_vote_req = mbox.msg_type == MSG_VOTE_REQ
    is_vote_reply = mbox.msg_type == MSG_VOTE_REPLY
    is_prevote_req = mbox.msg_type == MSG_PREVOTE_REQ
    is_prevote_reply = mbox.msg_type == MSG_PREVOTE_REPLY
    has_msg = mbox.msg_type != MSG_NONE

    term0 = state.current_term
    voted0 = state.voted_for
    role0 = state.role

    # -- universal higher-term handling (pre-vote requests excluded: they
    #    probe without dethroning; pre-vote *replies* carry real terms)
    bumps_term = has_msg & ~is_prevote_req & (mbox.term > term0)
    term1 = torch.where(bumps_term, mbox.term, term0)
    voted1 = torch.where(bumps_term, -1, voted0)
    role1 = torch.where(bumps_term, R_FOLLOWER, role0)
    leader1 = torch.where(bumps_term, -1, state.leader_slot)

    # ---------------- AER (follower accept path) ----------------
    local_prev_term, prev_known = term_at(state, mbox.prev_idx)
    # host-resolved override (deep backfill outside the device window)
    prev_override = (mbox.host_term_idx == mbox.prev_idx) & (mbox.host_term_val >= 0)
    local_prev_term = torch.where(prev_override, mbox.host_term_val, local_prev_term)
    prev_known = prev_known | prev_override
    aer_stale = mbox.term < term1
    aer_behind = mbox.prev_idx < state.snapshot_index
    aer_match = prev_known & (local_prev_term == mbox.prev_term)
    aer_code = torch.where(
        aer_stale,
        AER_STALE,
        torch.where(
            aer_behind,
            AER_BEHIND_SNAPSHOT,
            torch.where(aer_match, AER_OK, AER_MISMATCH),
        ),
    ).to(_I32)
    aer_ok = is_aer & (aer_code == AER_OK)
    aer_fail_next = torch.where(
        aer_behind,
        state.snapshot_index + 1,
        torch.where(
            state.last_index < mbox.prev_idx,
            state.last_index + 1,
            state.commit_index + 1,
        ),
    )
    # host fallback when prev-term unknown on device (deep backfill)
    aer_needs_host = is_aer & ~aer_stale & ~aer_behind & ~prev_known

    # accepting an AER names the sender leader and becomes follower
    role2 = torch.where(aer_ok, R_FOLLOWER, role1)
    leader2 = torch.where(aer_ok, mbox.sender_slot, leader1)

    # log tail bookkeeping for accepted entries (host writes the bytes;
    # device tracks the resulting tail)
    new_last = mbox.prev_idx + mbox.num_entries
    takes_entries = aer_ok & (mbox.num_entries > 0)
    last_index2 = torch.where(takes_entries, new_last, state.last_index)
    last_term2 = torch.where(takes_entries, mbox.entries_last_term, state.last_term)
    # record the accepted tail term in the ring (exact for the batch's
    # last entry; the host's record_appended covers the rest)
    kk = state.term_suffix.shape[-1]
    tail_slot = (new_last % kk)[:, None]
    term_suffix2 = torch.where(
        (_arange(kk, new_last)[None, :] == tail_slot) & takes_entries[:, None],
        mbox.entries_last_term[:, None],
        state.term_suffix,
    )
    # only the batch tail's term is exact: mark intermediate indexes of a
    # multi-entry accept stale until the host record_appended reconciles
    multi = takes_entries & (mbox.num_entries > 1)
    had_inv = state.unknown_lo <= state.unknown_hi
    unknown_lo2 = torch.where(
        multi,
        torch.where(had_inv, torch.minimum(state.unknown_lo, mbox.prev_idx + 1),
                    mbox.prev_idx + 1),
        state.unknown_lo,
    )
    unknown_hi2 = torch.where(
        multi, torch.maximum(state.unknown_hi, new_last - 1), state.unknown_hi
    )
    # followers' commit index: min(leader_commit, last entry index)
    commit2 = torch.where(
        aer_ok,
        torch.maximum(state.commit_index, torch.minimum(mbox.leader_commit, new_last)),
        state.commit_index,
    )

    # ---------------- votes ----------------
    fresh_term = mbox.term > term0
    free_to_vote = fresh_term | (voted1 == -1) | (voted1 == mbox.sender_slot)
    up_to_date = _log_up_to_date(
        last_index2, last_term2, mbox.cand_last_idx, mbox.cand_last_term
    )
    vote_grant = is_vote_req & (mbox.term >= term1) & free_to_vote & up_to_date
    voted2 = torch.where(vote_grant, mbox.sender_slot, voted1)
    leader3 = torch.where(vote_grant, -1, leader2)

    prevote_grant = (
        is_prevote_req
        & (mbox.term >= term1)
        & (mbox.cand_machine_version >= state.machine_version)
        & up_to_date
    )

    # ---------------- vote replies (candidate/pre_vote path) ----------------
    sender_onehot = peers == mbox.sender_slot[:, None]
    count_vote = is_vote_reply & (role1 == R_CANDIDATE) & mbox.success & (mbox.term == term1)
    votes2 = (count_vote[:, None] & sender_onehot) | state.votes
    votes2 = votes2 & (role1[:, None] == R_CANDIDATE)
    count_prevote = (
        is_prevote_reply
        & (role1 == R_PRE_VOTE)
        & mbox.success
        & (mbox.term <= term1)
        & (mbox.token == state.pre_vote_token)
    )
    pre_votes2 = (count_prevote[:, None] & sender_onehot) | state.pre_votes
    pre_votes2 = pre_votes2 & (role1[:, None] == R_PRE_VOTE)

    members = state.voting & state.active
    n_voters = torch.sum(members, dim=-1, dtype=_I32)
    quorum_n = n_voters // 2 + 1
    # take_along_axis fill mode: an out-of-range slot reads True
    slot_ok = (state.self_slot >= 0) & (state.self_slot < P)
    self_vote = torch.where(
        slot_ok, _at_col(members, state.self_slot.clamp(0, P - 1)), True
    )
    n_votes = torch.sum(votes2 & members, dim=-1, dtype=_I32) + (
        self_vote & (role1 == R_CANDIDATE)
    ).to(_I32)
    n_prevotes = torch.sum(pre_votes2 & members, dim=-1, dtype=_I32) + (
        self_vote & (role1 == R_PRE_VOTE)
    ).to(_I32)
    became_leader = (role1 == R_CANDIDATE) & (n_votes >= quorum_n)
    became_candidate = (role1 == R_PRE_VOTE) & (n_prevotes >= quorum_n)

    role3 = torch.where(became_leader, R_LEADER, role2)
    role3 = torch.where(became_candidate, R_CANDIDATE, role3)
    # candidate promotion bumps the term and votes for self
    term2 = torch.where(became_candidate, term1 + 1, term1)
    voted3 = torch.where(became_candidate, state.self_slot, voted2)
    leader4 = torch.where(became_leader, state.self_slot, leader3)
    votes3 = votes2 & ~became_candidate[:, None]
    pre_votes3 = pre_votes2 & ~became_candidate[:, None]

    # new leader resets peer bookkeeping
    match2 = torch.where(became_leader[:, None], 0, state.match_index)
    next2 = torch.where(
        became_leader[:, None], (last_index2 + 1)[:, None], state.next_index
    )

    # ---------------- AER replies (leader path) ----------------
    lead_ok = is_aer_reply & (role3 == R_LEADER) & (mbox.term == term2)
    succ = (lead_ok & mbox.success)[:, None] & sender_onehot
    match3 = torch.where(
        succ, torch.maximum(match2, mbox.reply_last_idx[:, None]), match2
    )
    next3 = torch.where(
        succ, torch.maximum(next2, mbox.reply_last_idx[:, None] + 1), next2
    )
    fail = (lead_ok & ~mbox.success)[:, None] & sender_onehot
    fail_hint = torch.maximum(
        torch.minimum(mbox.reply_next_idx, mbox.reply_last_idx + 1)[:, None],
        match3 + 1,
    )
    next4 = torch.where(fail, torch.clamp(fail_hint, min=1), next3)

    # ---------------- quorum commit scan (leaders, every step) ----------------
    is_self = peers == state.self_slot[:, None]
    eff_match = torch.where(is_self, state.written_index[:, None], match3)
    if _QUORUM_BACKEND == "kernel" and P <= quorum.MAX_P:
        agreed = quorum.agreed_commit(eff_match, members, n_voters)
    else:
        if P > quorum.MAX_P:
            # P > 8 exceeds the kernel's register network: sort formulation
            WIDE_SORT_STEPS += 1
        agreed = agreed_commit_sort(eff_match, members, n_voters)
    agreed_term, agreed_known = term_at(
        state._replace(
            last_index=last_index2,
            last_term=last_term2,
            term_suffix=term_suffix2,
            unknown_lo=unknown_lo2,
            unknown_hi=unknown_hi2,
        ),
        agreed,
    )
    agreed_override = (mbox.host_term_idx == agreed) & (mbox.host_term_val >= 0)
    agreed_term = torch.where(agreed_override, mbox.host_term_val, agreed_term)
    agreed_known = agreed_known | agreed_override
    can_commit = (
        (role3 == R_LEADER)
        & (agreed > commit2)
        & agreed_known
        & (agreed_term == term2)
    )
    commit3 = torch.where(can_commit, agreed, commit2)
    quorum_needs_host = (role3 == R_LEADER) & (agreed > commit2) & ~agreed_known

    # ---------------- egress ----------------
    reply_success = torch.where(
        is_aer,
        aer_code == AER_OK,
        torch.where(is_vote_req, vote_grant, is_prevote_req & prevote_grant),
    )
    # AER success replies report the durable watermark
    wi = torch.where(aer_ok, state.written_index, last_index2)
    reply_next = torch.where(
        is_aer & (aer_code != AER_OK), aer_fail_next, wi + 1
    )
    egress = Egress(
        # a needs_host AER is resolved entirely by the host oracle — the
        # device must not also emit its (bogus) mismatch rejection
        send_reply=has_msg & ((is_aer & ~aer_needs_host) | is_vote_req | is_prevote_req),
        reply_type=mbox.msg_type,
        reply_to=mbox.sender_slot,
        term=term2,
        success=reply_success,
        next_index=reply_next,
        last_index=torch.where(is_aer & aer_ok, wi, last_index2),
        last_term=last_term2,
        aer_code=torch.where(is_aer, aer_code, -1),
        became_leader=became_leader,
        became_candidate=became_candidate,
        commit_advanced_to=commit3,
        needs_host=aer_needs_host | quorum_needs_host,
        term_or_vote_changed=(term2 != term0) | (voted3 != voted0),
        role=role3,
        leader_slot=leader4,
        agreed_idx=agreed,
        voted_for=voted3,
    )
    new_state = state._replace(
        current_term=term2,
        voted_for=voted3,
        commit_index=commit3,
        last_index=last_index2,
        last_term=last_term2,
        role=role3,
        leader_slot=leader4,
        match_index=match3,
        next_index=next4,
        votes=votes3,
        pre_votes=pre_votes3,
        term_suffix=term_suffix2,
        unknown_lo=unknown_lo2,
        unknown_hi=unknown_hi2,
    )
    return new_state, egress


# The step entry point (the JAX package jits and donates; here it runs
# eagerly and returns fresh tensors).
consensus_step = consensus_step_impl


# Packed interface: the host coordinator ships the whole mailbox as ONE
# (len(MBOX_FIELDS), G) int32 tensor and receives the egress as ONE
# (len(EGRESS_FIELDS), G) int32 tensor — a single transfer each way per
# step. reply_to is intentionally omitted from the egress pack (hosts
# address replies via the consumed message's sender).
MBOX_FIELDS = [
    "msg_type", "sender_slot", "term", "prev_idx", "prev_term",
    "num_entries", "entries_last_term", "leader_commit", "success",
    "reply_next_idx", "reply_last_idx", "reply_last_term", "cand_last_idx",
    "cand_last_term", "cand_machine_version", "host_term_idx",
    "host_term_val", "token",
]
EGRESS_FIELDS = [
    "send_reply", "reply_type", "term", "success", "next_index",
    "last_index", "last_term", "aer_code", "became_leader",
    "became_candidate", "commit_advanced_to", "needs_host",
    "term_or_vote_changed", "role", "leader_slot", "agreed_idx",
    "voted_for",
]

# packed lists must track the namedtuples: a drifted field name would be
# silently dropped on the host side
if set(MBOX_FIELDS) != set(Mailbox._fields):
    raise ImportError(f"MBOX_FIELDS drifted: {set(MBOX_FIELDS) ^ set(Mailbox._fields)}")
if set(EGRESS_FIELDS) != set(Egress._fields) - {"reply_to"}:
    raise ImportError("EGRESS_FIELDS drifted from Egress")


def _unpack_mailbox(packed: torch.Tensor) -> Mailbox:
    rows = {name: packed[i] for i, name in enumerate(MBOX_FIELDS)}
    rows["success"] = rows["success"] != 0
    return Mailbox(**rows)


def _pack_egress(eg: Egress) -> torch.Tensor:
    return torch.stack([getattr(eg, name).to(_I32) for name in EGRESS_FIELDS])


def consensus_step_packed(state: GroupState, packed: torch.Tensor):
    new_state, eg = consensus_step_impl(state, _unpack_mailbox(packed))
    return new_state, _pack_egress(eg)


def consensus_step_packed_sub(
    state: GroupState, packed: torch.Tensor, gidx: torch.Tensor
):
    """Active-set step: gather ONLY the rows named by ``gidx`` (an i32
    vector padded to a power of two with out-of-range ids), run the
    fused step over the compact sub-batch, scatter results back. Pad
    rows gather a clamped row's state but their writes are dropped on
    the scatter, so they cannot perturb any real group."""
    sub = GroupState(*(_take(a, gidx) for a in state))
    sub_new, eg = consensus_step_impl(sub, _unpack_mailbox(packed))
    new_state = GroupState(
        *(scatter_set(full, gidx, s) for full, s in zip(state, sub_new))
    )
    return new_state, _pack_egress(eg)


# Scatter-fused packed interface: the host's queued log-tail updates ride
# the SAME packed tensor as the mailbox — six extra rows after
# MBOX_FIELDS — and are applied at the START of the step, before the
# quorum scan. Pad entries carry an out-of-range gid (>= capacity);
# scatters drop them. a_* rows are contiguous same-term appended runs
# (one per group, gids unique); w_* rows are durable watermarks.
MBOX_SCAT_FIELDS = ["a_gid", "a_lo", "a_hi", "a_term", "w_gid", "w_idx"]


def _apply_packed_scatters(state: GroupState, packed: torch.Tensor) -> GroupState:
    # row-space form of record_appended_runs + record_written: every
    # temporary is (rows, k)-shaped, never (G, ...)-shaped. Tails advance
    # by max, ring slots in [lo, hi] take the run term, last_term re-reads
    # the updated ring at the (possibly unmoved) tail, staleness clears;
    # pad rows (gid >= G) drop on every scatter.
    base = len(MBOX_FIELDS)
    gids = packed[base]
    los = packed[base + 1]
    his = packed[base + 2]
    terms = packed[base + 3]
    k = state.term_suffix.shape[-1]
    los_c = torch.maximum(los, his - (k - 1))
    slots = _arange(k, his)[None, :]
    # largest index i <= hi with i % k == slot
    idx_at_slot = his[:, None] - ((his[:, None] - slots) % k)
    mask = idx_at_slot >= los_c[:, None]
    cur = _get_fill(state.term_suffix, gids, 0)
    rows = torch.where(mask, terms[:, None], cur)
    ts = scatter_set(state.term_suffix, gids, rows)
    old_last = _get_fill(state.last_index, gids, 0)
    new_last = torch.maximum(old_last, his)
    last_index = scatter_set(state.last_index, gids, new_last)
    ring_at_tail = _at_col(rows, new_last % k)
    last_term = scatter_set(state.last_term, gids, ring_at_tail)
    unknown_lo = scatter_set(state.unknown_lo, gids, 1)
    unknown_hi = scatter_set(state.unknown_hi, gids, 0)
    return state._replace(
        term_suffix=ts,
        last_index=last_index,
        last_term=last_term,
        unknown_lo=unknown_lo,
        unknown_hi=unknown_hi,
        written_index=scatter_max(
            state.written_index, packed[base + 4], packed[base + 5]
        ),
    )


def consensus_step_packed_scat(state: GroupState, packed: torch.Tensor):
    state = _apply_packed_scatters(state, packed)
    return consensus_step_packed(state, packed)


def consensus_step_packed_sub_scat(
    state: GroupState, packed: torch.Tensor, gidx: torch.Tensor
):
    # scatters apply to the FULL state before the active-set gather
    # (every appended/written group is in the active set by
    # construction, so the gathered sub-batch sees the new tails)
    state = _apply_packed_scatters(state, packed)
    return consensus_step_packed_sub(state, packed, gidx)


# ---------------------------------------------------------------------------
# host-side helpers for log-tail maintenance


def record_appended(
    state: GroupState, group_ids: torch.Tensor, idxs: torch.Tensor,
    terms: torch.Tensor,
) -> GroupState:
    """Record host-appended entries (scatter into the term ring buffer and
    advance the tails of the named groups). A batch may carry several
    entries for one group. Where two entries land in one ring slot of
    one group (a legacy run longer than K), the one listed last wins —
    the newest write, since the host lists entries in write order. That
    is the JAX package's CPU order, made deterministic on the card
    (``index_put_`` leaves the winner of duplicates undefined there)."""
    g, k = state.term_suffix.shape
    gi = _wrap(group_ids, g)
    ok = (gi >= 0) & (gi < g)
    key = torch.where(ok, gi * k + (idxs % k).long(), g * k)
    # the last listed entry of each (group, slot) key is its only writer
    pos = torch.arange(idxs.shape[0], dtype=torch.int64, device=idxs.device)
    last = torch.full((g * k + 1,), -1, dtype=torch.int64, device=idxs.device)
    last.scatter_reduce_(0, key, pos, "amax", include_self=True)
    win = ok & (last[key] == pos)
    flat = state.term_suffix.new_empty(g * k + 1)
    flat[: g * k] = state.term_suffix.reshape(-1)
    flat.index_put_((torch.where(win, key, g * k),), terms.to(_I32))
    ts = flat[: g * k].view(g, k)
    # .max is order-independent under duplicate group indices...
    last_index = scatter_max(state.last_index, group_ids, idxs)
    # ...and last_term is then read back from the ring at the new tail
    touched = _touched(state.last_index, group_ids)
    ring_at_tail = _at_col(ts, last_index % k)
    last_term = torch.where(touched, ring_at_tail, state.last_term)
    # the host has reconciled these groups' rings exactly: clear staleness
    unknown_lo = torch.where(touched, 1, state.unknown_lo)
    unknown_hi = torch.where(touched, 0, state.unknown_hi)
    return state._replace(
        term_suffix=ts,
        last_index=last_index,
        last_term=last_term,
        unknown_lo=unknown_lo,
        unknown_hi=unknown_hi,
    )


def record_appended_runs(
    state: GroupState,
    group_ids: torch.Tensor,
    los: torch.Tensor,
    his: torch.Tensor,
    terms: torch.Tensor,
) -> GroupState:
    """Record contiguous same-term appended runs — ONE row per group.
    ``group_ids`` must be unique within the call (pad with an out-of-range
    gid). Ring slots covered by [lo, hi] are filled with ``term``;
    tails/staleness update as in ``record_appended``."""
    k = state.term_suffix.shape[-1]
    los_c = torch.maximum(los, his - (k - 1))
    slots = _arange(k, his)[None, :]
    # largest index i <= hi with i % k == slot
    idx_at_slot = his[:, None] - ((his[:, None] - slots) % k)
    mask = idx_at_slot >= los_c[:, None]
    cur = _get_fill(state.term_suffix, group_ids, 0)
    rows = torch.where(mask, terms[:, None], cur)
    ts = scatter_set(state.term_suffix, group_ids, rows)
    last_index = scatter_max(state.last_index, group_ids, his)
    touched = _touched(state.last_index, group_ids)
    ring_at_tail = _at_col(ts, last_index % k)
    last_term = torch.where(touched, ring_at_tail, state.last_term)
    unknown_lo = torch.where(touched, 1, state.unknown_lo)
    unknown_hi = torch.where(touched, 0, state.unknown_hi)
    return state._replace(
        term_suffix=ts,
        last_index=last_index,
        last_term=last_term,
        unknown_lo=unknown_lo,
        unknown_hi=unknown_hi,
    )


def record_written(
    state: GroupState, group_ids: torch.Tensor, idxs: torch.Tensor
) -> GroupState:
    """Advance durable watermarks after WAL fsync."""
    return state._replace(
        written_index=scatter_max(state.written_index, group_ids, idxs)
    )


def record_snapshot(
    state: GroupState, group_ids: torch.Tensor, idxs: torch.Tensor,
    terms: torch.Tensor,
) -> GroupState:
    """Host installed snapshots for the named groups: move the snapshot
    boundary, advance tails/watermarks/commit, clear ring staleness."""
    touched = _touched(state.role, group_ids)
    snap_idx = scatter_set(state.snapshot_index, group_ids, idxs)
    snap_term = scatter_set(state.snapshot_term, group_ids, terms)
    last_index = scatter_max(state.last_index, group_ids, idxs)
    at_snap = last_index == snap_idx
    last_term = torch.where(touched & at_snap, snap_term, state.last_term)
    written = scatter_max(state.written_index, group_ids, idxs)
    commit = scatter_max(state.commit_index, group_ids, idxs)
    unknown_lo = torch.where(touched, 1, state.unknown_lo)
    unknown_hi = torch.where(touched, 0, state.unknown_hi)
    return state._replace(
        snapshot_index=snap_idx,
        snapshot_term=snap_term,
        last_index=last_index,
        last_term=last_term,
        written_index=written,
        commit_index=commit,
        unknown_lo=unknown_lo,
        unknown_hi=unknown_hi,
    )


def force_elections(state: GroupState, group_ids: torch.Tensor) -> GroupState:
    """Leadership-transfer fast path: the named groups become candidates
    IMMEDIATELY — term+1, vote for self, tallies cleared — skipping the
    pre-vote round (Raft §3.10). The host persists the bumped
    term/self-vote before any vote request leaves."""
    touched = _touched(state.role, group_ids)
    return state._replace(
        role=torch.where(touched, R_CANDIDATE, state.role),
        current_term=torch.where(
            touched, state.current_term + 1, state.current_term
        ),
        voted_for=torch.where(touched, state.self_slot, state.voted_for),
        leader_slot=torch.where(touched, -1, state.leader_slot),
        votes=state.votes & ~touched[:, None],
        pre_votes=state.pre_votes & ~touched[:, None],
    )


def set_roles(
    state: GroupState, group_ids: torch.Tensor, roles: torch.Tensor
) -> GroupState:
    """Host-driven role transitions (election initiation and similar rare
    paths): scatter new roles and clear election tallies for the named
    groups."""
    role = scatter_set(state.role, group_ids, roles)
    touched = _touched(state.role, group_ids)
    votes = state.votes & ~touched[:, None]
    pre_votes = state.pre_votes & ~touched[:, None]
    # entering pre-vote opens a new round: bump the token so replies from
    # earlier rounds are ignored (the host mirrors this in
    # GroupHost.pre_vote_token)
    tok = scatter_add(state.pre_vote_token, group_ids, (roles == R_PRE_VOTE).to(_I32))
    return state._replace(
        role=role, votes=votes, pre_votes=pre_votes, pre_vote_token=tok
    )
