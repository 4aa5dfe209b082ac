"""Scalar consensus decision functions — the oracle spec.

These are the *pure decision kernels* of Raft, extracted from the server
so that (a) the scalar server core and (b) the vectorized JAX kernels in
``ra_tpu_torch.ops.consensus`` implement exactly the same math and can be
checked trace-for-trace against each other. They correspond to the three
north-star hot paths of the reference:

- AppendEntries term/prev-log matching (reference: src/ra_server.erl
  handle_follower :1283-1429, has_log_entry_or_snapshot :3168);
- RequestVote / PreVote grant logic (reference: src/ra_server.erl
  :1489-1529, process_pre_vote :2926-2984, is_candidate_log_up_to_date
  :3159-3165);
- match_index -> commit_index quorum scan (reference: src/ra_server.erl
  evaluate_quorum/increment_commit_index/agreed_commit :3633-3688).

Everything here is branch-light integer math over small tuples so the
vectorized versions are direct transcriptions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# AER accept decision codes
AER_STALE = 0  # rpc.term < current_term: reject, keep ours
AER_OK = 1  # prev matches: accept/append
AER_MISMATCH = 2  # prev missing or term conflict: reject with hint
AER_BEHIND_SNAPSHOT = 3  # prev_idx below our snapshot: leader is behind us


def log_up_to_date(
    our_last_idx: int, our_last_term: int, cand_last_idx: int, cand_last_term: int
) -> bool:
    """Raft 5.4.1: candidate's log is at least as up-to-date as ours."""
    return (cand_last_term > our_last_term) or (
        cand_last_term == our_last_term and cand_last_idx >= our_last_idx
    )


def aer_decision(
    current_term: int,
    rpc_term: int,
    prev_idx: int,
    prev_term: int,
    local_prev_term: int,  # term of our entry at prev_idx, -1 if absent
    snapshot_idx: int,  # our snapshot index, 0 if none
) -> int:
    """Classify an AppendEntries RPC. ``local_prev_term`` must be -1 when
    we have no entry at prev_idx (and prev_idx is not our snapshot index —
    callers fold the snapshot term into local_prev_term when it applies;
    prev_idx == 0 always matches with local_prev_term == 0)."""
    if rpc_term < current_term:
        return AER_STALE
    if prev_idx < snapshot_idx:
        return AER_BEHIND_SNAPSHOT
    if local_prev_term >= 0 and local_prev_term == prev_term:
        return AER_OK
    return AER_MISMATCH


def aer_failure_next_index(
    commit_index: int, our_last_idx: int, prev_idx: int, snapshot_idx: int
) -> int:
    """next_index hint carried in a failed AppendEntries reply.

    - behind-snapshot: point the leader past our snapshot;
    - short log: ask from our tail;
    - term conflict: back off to the first unknown-good index; committed
      entries always match, so commit_index + 1 is safe and live.
    """
    if prev_idx < snapshot_idx:
        return snapshot_idx + 1
    if our_last_idx < prev_idx:
        return our_last_idx + 1
    return commit_index + 1


def vote_decision(
    current_term: int,
    voted_for: int,  # peer slot we voted for this term; -1 = none
    candidate: int,  # candidate's peer slot
    rpc_term: int,
    cand_last_idx: int,
    cand_last_term: int,
    our_last_idx: int,
    our_last_term: int,
) -> Tuple[bool, int]:
    """RequestVote: returns (grant, new_current_term). A higher rpc term
    always bumps our term (even when the vote is denied); voted_for
    persistence is the caller's job."""
    term = max(current_term, rpc_term)
    if rpc_term < current_term:
        return False, term
    fresh_term = rpc_term > current_term
    free_to_vote = fresh_term or voted_for < 0 or voted_for == candidate
    grant = free_to_vote and log_up_to_date(
        our_last_idx, our_last_term, cand_last_idx, cand_last_term
    )
    return grant, term


def pre_vote_decision(
    current_term: int,
    rpc_term: int,
    cand_machine_version: int,
    our_machine_version: int,
    cand_last_idx: int,
    cand_last_term: int,
    our_last_idx: int,
    our_last_term: int,
) -> bool:
    """PreVote grant: no term change, no persistence. Granted iff the
    candidate's term is not behind ours, its log is up to date, and it
    supports at least our effective machine version (reference gating:
    src/ra_server.erl:2926-2984)."""
    return (
        rpc_term >= current_term
        and cand_machine_version >= our_machine_version
        and log_up_to_date(our_last_idx, our_last_term, cand_last_idx, cand_last_term)
    )


def agreed_commit(match_indexes: Sequence[int]) -> int:
    """Highest index replicated on a quorum: sort descending, take the
    majority-th element (reference: agreed_commit src/ra_server.erl:
    3684-3688). ``match_indexes`` must contain one entry per *voter*,
    including the leader's own durable watermark."""
    srt = sorted(match_indexes, reverse=True)
    quorum = len(srt) // 2  # 0-based index of the majority-th element
    return srt[quorum]


def new_commit_index(
    match_indexes: Sequence[int],
    current_commit: int,
    term_at_agreed: int,
    current_term: int,
) -> int:
    """Commit-index advance: only entries from the current term may
    commit by counting (Raft 5.4.2). ``term_at_agreed`` is the log term
    at ``agreed_commit(match_indexes)``."""
    agreed = agreed_commit(match_indexes)
    if agreed > current_commit and term_at_agreed == current_term:
        return agreed
    return current_commit
