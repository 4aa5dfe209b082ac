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
- the main-path steps ``consensus_step_packed_scat`` and
  ``consensus_step_packed_sub_scat`` dispatch on the device: CPU
  tensors run the plain torch-op step (``*_plain`` below); CUDA tensors
  launch the hand-written step kernel (``ops.step``, ``csrc/step.cu``:
  scatters, decisions, the quorum network inlined, egress, in a handful
  of launches, at any peer width) or raise. On the TPU, XLA fused the
  whole step; eager PyTorch offers no such fusion;
- in the plain step the quorum scan's default backend is the
  hand-written CUDA kernel (``ops.quorum``) on CUDA tensors and its
  plain sort version on CPU tensors. ``configure(quorum_backend=
  "sort")`` selects the plain sort formulation explicitly;
- over a mesh of N devices the state is a ``ShardedState``: N equal
  slices of the group axis, each stepped alone (``split_mailbox``,
  ``consensus_step_packed_scat_sharded``, ``join_egress``).
"""

from __future__ import annotations

import threading
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


def state_to_numpy(state) -> dict:
    """Host numpy copies of every field, keyed by name. A
    ``ShardedState`` gives the whole group axis, in gid order."""
    if isinstance(state, ShardedState):
        parts = [state_to_numpy(s) for s in state.shards]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


# ---------------------------------------------------------------------------
# JAX index modes, written out


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=like.device)


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ids with negatives wrapped once, as JAX normalises them."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _get_fill(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``arr.at[idx].get(mode="fill", fill_value=fill)`` along axis 0."""
    n = arr.shape[0]
    i = _wrap(idx, n)
    ok = (i >= 0) & (i < n)
    got = arr[i.clamp(0, n - 1)]
    if got.dim() > 1:
        ok = ok.view(-1, *([1] * (got.dim() - 1)))
    return torch.where(ok, got, fill)


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as int64 with negatives wrapped once and every id still
    out of range routed to row ``n``, the scratch row of a drop buffer
    (``mode="drop"``)."""
    i = _wrap(idx, n)
    return torch.where((i >= 0) & (i < n), i, n)


def _with_scratch_row(arr: torch.Tensor) -> torch.Tensor:
    """A copy of ``arr`` with one scratch row appended."""
    n = arr.shape[0]
    buf = arr.new_empty((n + 1,) + tuple(arr.shape[1:]))
    buf[:n] = arr
    return buf


def _drop_buffer(arr: torch.Tensor, idx: torch.Tensor):
    """A copy of ``arr`` with one scratch row appended, and ``idx`` with
    every out-of-range id routed to that row (``mode="drop"``)."""
    return _with_scratch_row(arr), _drop_index(idx, arr.shape[0])


def _set_rows(arr: torch.Tensor, i: torch.Tensor, vals) -> torch.Tensor:
    """``scatter_set`` with the ids already through ``_drop_index``."""
    n = arr.shape[0]
    buf = _with_scratch_row(arr)
    if not torch.is_tensor(vals):
        vals = torch.full(tuple(i.shape) + tuple(arr.shape[1:]), vals,
                          dtype=arr.dtype, device=arr.device)
    buf.index_put_((i,), vals.to(arr.dtype))
    return buf[:n]


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` along axis 0 (ids must be
    unique among the in-range rows, as in JAX)."""
    return _set_rows(arr, _drop_index(idx, arr.shape[0]), vals)


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
    # take_along_axis: a slot in [-P, 0) wraps once, one still out of
    # range reads True (fill mode)
    slot = torch.where(state.self_slot < 0, state.self_slot + P, state.self_slot)
    slot_ok = (slot >= 0) & (slot < P)
    self_vote = torch.where(slot_ok, _at_col(members, slot.clamp(0, P - 1)), True)
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
    # the gather and scatter ids are the same for every field: convert
    # them once (the plain step's cost on the CPU is its op count). JAX's
    # gather wraps negative ids and clamps out-of-range ones.
    G = state.role.shape[0]
    take = _wrap(gidx, G).clamp(0, G - 1)
    sub = GroupState(*(a[take] for a in state))
    sub_new, eg = consensus_step_impl(sub, _unpack_mailbox(packed))
    put = _drop_index(gidx, G)
    new_state = GroupState(
        *(_set_rows(full, put, s) for full, s in zip(state, sub_new))
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
    G = state.last_index.shape[0]
    # the ids address every [G] field alike: convert them once
    put = _drop_index(gids, G)
    ok = put < G
    at = put.clamp(0, G - 1)
    los_c = torch.maximum(los, his - (k - 1))
    slots = _arange(k, his)[None, :]
    # largest index i <= hi with i % k == slot
    idx_at_slot = his[:, None] - ((his[:, None] - slots) % k)
    mask = idx_at_slot >= los_c[:, None]
    cur = torch.where(ok[:, None], state.term_suffix[at], 0)
    rows = torch.where(mask, terms[:, None], cur)
    ts = _set_rows(state.term_suffix, put, rows)
    old_last = torch.where(ok, state.last_index[at], 0)
    new_last = torch.maximum(old_last, his)
    last_index = _set_rows(state.last_index, put, new_last)
    ring_at_tail = _at_col(rows, new_last % k)
    last_term = _set_rows(state.last_term, put, ring_at_tail)
    unknown_lo = _set_rows(state.unknown_lo, put, 1)
    unknown_hi = _set_rows(state.unknown_hi, put, 0)
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


def consensus_step_packed_scat_plain(state: GroupState, packed: torch.Tensor):
    """The full-width main-path step on torch ops (the plain version of
    the step kernel)."""
    state = _apply_packed_scatters(state, packed)
    return consensus_step_packed(state, packed)


def consensus_step_packed_sub_scat_plain(
    state: GroupState, packed: torch.Tensor, gidx: torch.Tensor
):
    """The active-set main-path step on torch ops (the plain version of
    the step kernel)."""
    # scatters apply to the FULL state before the active-set gather
    # (every appended/written group is in the active set by
    # construction, so the gathered sub-batch sees the new tails)
    state = _apply_packed_scatters(state, packed)
    return consensus_step_packed_sub(state, packed, gidx)


# The plain step on CPU tensors is some hundreds of small torch ops, and
# each releases the interpreter lock. Coordinators stepping at once in
# one process then hand that lock back and forth on every op: at capacity
# 8 an active-set step of about 2 ms alone took about 30 ms with three
# threads stepping (scripts/cpu_step_threads.py), too slow for a pre-vote
# round to finish between elections 80 ms apart, where the JAX package's
# step (one compiled call) finishes it. The CPU route takes this lock for
# the whole step, so steps of one process run one after another at their
# single-thread speed.
_CPU_STEP_LOCK = threading.Lock()


def consensus_step_packed_scat(state: GroupState, packed: torch.Tensor):
    """The full-width main-path step: the packed scatters, then the step
    over every group. CPU tensors run the plain version (under
    ``_CPU_STEP_LOCK``); CUDA tensors launch the step kernel (or
    raise)."""
    from ra_tpu_torch.ops import step  # it reads this module's layouts

    step.check(state, packed)
    if packed.device.type == "cpu":
        with _CPU_STEP_LOCK:
            return consensus_step_packed_scat_plain(state, packed)
    return step.launch_full(state, packed)


def consensus_step_packed_sub_scat(
    state: GroupState, packed: torch.Tensor, gidx: torch.Tensor
):
    """The active-set main-path step: the packed scatters on the full
    state, then the step over the groups named by ``gidx`` (pad ids
    gather a clamped row and drop their writes). Dispatches as
    ``consensus_step_packed_scat`` does."""
    from ra_tpu_torch.ops import step

    step.check(state, packed, gidx)
    if packed.device.type == "cpu":
        with _CPU_STEP_LOCK:
            return consensus_step_packed_sub_scat_plain(state, packed, gidx)
    return step.launch_sub(state, packed, gidx)


# ---------------------------------------------------------------------------
# the group axis in shards (the multi-device path)
#
# A mesh of N devices holds the state as N equal slices of the group
# axis: shard s holds gids [s*Gs, (s+1)*Gs), Gs = G/N, on its own device
# (devices may repeat). Every group's decisions are independent, so each
# shard steps alone, with no communication; a gid enters a shard rebased
# to gid - s*Gs. The JAX package shards the same axis over a
# ``jax.sharding.Mesh`` and lets GSPMD route.


class ShardedState:
    """A ``GroupState`` cut along the group axis into equal shards, in
    gid order. Immutable, as a ``GroupState`` is."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = tuple(shards)

    @property
    def shard_groups(self) -> int:
        return self.shards[0].role.shape[0]


def split_state(state: GroupState, devices) -> ShardedState:
    """``state`` cut into ``len(devices)`` equal shards, shard s copied
    to ``devices[s]``."""
    n = len(devices)
    g = state.role.shape[0]
    if g % n:
        raise ValueError(f"capacity {g} not divisible by mesh size {n}")
    gs = g // n
    return ShardedState(
        GroupState(*(f[s * gs:(s + 1) * gs].to(resolve_device(d), copy=True)
                     for f in state))
        for s, d in enumerate(devices)
    )


def route_gids(gids, g: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each host gid's shard of N and its id there, by JAX's index rule:
    a negative id wraps once; an id still out of range (a pad: ``G``
    among them) gets shard -1, and drops."""
    gi = np.asarray(gids, np.int64).reshape(-1)
    gi = np.where(gi < 0, gi + g, gi)
    gs = g // n
    shard = np.where((gi >= 0) & (gi < g), gi // gs, -1)
    return shard, gi - shard * gs


def split_mailbox(packed: np.ndarray, n: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """A full-width host mailbox ((24, G) int32) as N shard mailboxes
    ((N, 24, G/N) int32, written into ``out`` when given). The message
    rows split by column range. The scatter rows split by gid: each
    entry goes to shard gid // Gs with its gid rebased, in its order,
    and the rest of the shard's row is pads (gid Gs). A shard's entries
    fit its Gs columns when each row names a group at most once, as the
    coordinator's do; more entries than columns raise ValueError."""
    rows, g = packed.shape
    gs = g // n
    base = len(MBOX_FIELDS)
    if out is None:
        out = np.empty((n, rows, gs), np.int32)
    out[:, :base] = packed[:base].reshape(base, n, gs).transpose(1, 0, 2)
    out[:, base:] = 0
    for kind, gid_row, val_rows in (
            ("appended runs", base, (base + 1, base + 2, base + 3)),
            ("watermarks", base + 4, (base + 5,))):
        shard, local = route_gids(packed[gid_row], g, n)
        out[:, gid_row] = gs
        for s in range(n):
            sel = np.flatnonzero(shard == s)
            m = len(sel)
            if m > gs:
                raise ValueError(f"{kind}: {m} entries for shard {s}, "
                                 f"which has {gs} columns")
            out[s, gid_row, :m] = local[sel]
            for r in val_rows:
                out[s, r, :m] = packed[r, sel]
    return out


def join_egress(parts) -> np.ndarray:
    """The shards' egresses ((17, Gs) host arrays, in shard order) as one
    (17, G) egress in gid order."""
    return np.concatenate(parts, axis=1)


def consensus_step_packed_scat_sharded(state: ShardedState, mboxes):
    """The full-width main-path step, shard by shard: shard s steps with
    ``mboxes[s]`` (its (24, Gs) int32 mailbox from ``split_mailbox``, on
    its device) through ``consensus_step_packed_scat``, which on CUDA is
    one step-kernel launch a shard. Returns (the new ``ShardedState``,
    the shards' egresses in shard order)."""
    outs = [consensus_step_packed_scat(st, mb)
            for st, mb in zip(state.shards, mboxes)]
    return ShardedState(o[0] for o in outs), [o[1] for o in outs]


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
