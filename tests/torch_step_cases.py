"""Seeded inputs for the fused step's parity tests, built with numpy (the
card tests import no JAX): a consistent group state and packed mailboxes
with the edges the step kernel must reproduce bit for bit.

Edges: groups with no voting member (the quorum scan's agreed index is
-1), ``self_slot`` at -1, at -P (both wrap once) and below -P, ``self_slot``
and ``sender_slot`` at P and above (and a sender at -1), negative and out-of-range ``a_gid``, ``w_gid`` and ``gidx`` ids,
duplicate ``w_gid`` ids, empty appended runs (lo > hi), scatter rows for
groups outside the active set, an active set holding G-1 beside pad ids,
host term overrides, and (``near_max``) indexes and terms within a few of
``2**31 - 1``, where int32 sums wrap. ``shard_edges`` puts the scatter
rows at the edges of a mesh's shards.
"""

import numpy as np

from ra_tpu_torch.ops import consensus as C

I32_MAX = 2**31 - 1
BOOL_FIELDS = ("voting", "active", "votes", "pre_votes")
# rows of the packed mailbox
ROWS = tuple(C.MBOX_FIELDS + C.MBOX_SCAT_FIELDS)
R = {f: i for i, f in enumerate(ROWS)}


def state_fields(rng, g: int, p: int, k: int, near_max: bool = False,
                 negative_slots: bool = True) -> dict:
    """A seeded state: tails inside the term ring, ascending terms, every
    role, replies in flight; every 11th group has no voting member, every
    13th a self slot at or above P, and of every 17th one at -1, one at
    -P and one below -P (unless ``negative_slots`` is false; they draw
    nothing from ``rng``). ``near_max`` lifts indexes and terms to within
    a few of 2**31 - 1."""
    base = I32_MAX - 2 * k + 3 if near_max else 0
    tbase = I32_MAX - 4 if near_max else 0
    snap = base + rng.integers(0, 20 if not near_max else k, g)
    tail = rng.integers(0, k - 1, g)
    last = snap + tail
    snap_term = tbase + rng.integers(1, 3, g)
    suffix = np.zeros((g, k), np.int64)
    term = snap_term.copy()
    for off in range(k - 1):
        idx = snap + 1 + off
        live = idx <= last
        term = np.minimum(term + ((rng.random(g) < 0.3) & live), I32_MAX)
        suffix[np.arange(g)[live], (idx % k)[live]] = term[live]
    last_term = np.where(tail > 0, term, snap_term)
    cur = np.minimum(last_term + rng.integers(0, 2, g), I32_MAX)
    commit = np.minimum(snap + rng.integers(0, 4, g), last)
    written = np.clip(last - rng.integers(0, 3, g), snap, None)
    role = rng.choice([0, 1, 2, 3], size=g, p=[0.3, 0.2, 0.2, 0.3])
    self_slot = rng.integers(0, p, g)
    voting = rng.random((g, p)) < 0.85
    voting[np.arange(g), self_slot] = True
    voting[0::11] = False  # no voting member: agreed = -1
    self_slot[5::13] = p + rng.integers(0, 3, len(self_slot[5::13]))
    if negative_slots:
        self_slot[3::17] = -1
        self_slot[8::17] = -p
        self_slot[12::17] = -p - 1 - np.arange(len(self_slot[12::17])) % 3
    active = rng.random((g, p)) < 0.95
    match = np.minimum(base + rng.integers(0, 40, (g, p)), last[:, None])
    unknown = rng.random(g) < 0.2
    ulo = np.where(unknown, np.maximum(last - rng.integers(1, 4, g), snap), 1)
    uhi = np.where(unknown, last - 1, 0)
    f = {
        "current_term": cur, "voted_for": rng.integers(-1, p, g),
        "commit_index": commit, "last_applied": commit,
        "last_index": last, "last_term": last_term,
        "written_index": written, "snapshot_index": snap,
        "snapshot_term": snap_term, "role": role,
        "leader_slot": np.where(role == 3, self_slot, -1),
        "self_slot": self_slot, "machine_version": rng.integers(0, 2, g),
        "match_index": match, "next_index": np.minimum(match + 1, I32_MAX),
        "voting": voting, "active": active,
        "votes": rng.random((g, p)) < 0.3,
        "pre_votes": rng.random((g, p)) < 0.3,
        "term_suffix": suffix, "unknown_lo": ulo, "unknown_hi": uhi,
        "pre_vote_token": rng.integers(0, 3, g),
    }
    return {name: np.ascontiguousarray(
        v, np.bool_ if name in BOOL_FIELDS else np.int32)
        for name, v in f.items()}


def packed(rng, st: dict, cols: np.ndarray, width: int) -> np.ndarray:
    """A (24, width) packed mailbox whose column j carries a message for
    group ``cols[j]`` (ids wrap once and clamp, as the active-set gather
    does; columns past ``len(cols)`` are pads with no message), plus
    fused scatter rows with the id edges."""
    g, p = st["match_index"].shape
    k = st["term_suffix"].shape[1]
    n = len(cols)
    c = np.asarray(cols, np.int64)
    c = np.clip(np.where(c < 0, c + g, c), 0, g - 1)
    out = np.zeros((len(ROWS), width), np.int64)
    out[R["host_term_idx"]] = -1
    out[R["host_term_val"]] = -1
    cur = st["current_term"][c].astype(np.int64)
    last = st["last_index"][c].astype(np.int64)
    term = np.clip(cur + rng.integers(-1, 2, n), 0, I32_MAX)
    prev = np.clip(last - rng.integers(-1, 3, n), 0, I32_MAX)
    ring = st["term_suffix"][c, prev % k]
    sender = rng.integers(0, p, n)
    odd = rng.random(n) < 0.08
    sender[odd] = rng.choice([-1, p, p + 1, p + 5], size=int(odd.sum()))
    vals = {
        "msg_type": rng.choice(7, size=n,
                               p=[0.05, 0.3, 0.3, 0.09, 0.09, 0.08, 0.09]),
        "sender_slot": sender,
        "term": term, "prev_idx": prev,
        "prev_term": np.where(rng.random(n) < 0.7, ring, ring + 1),
        "num_entries": rng.integers(0, 4, n), "entries_last_term": term,
        "leader_commit": np.minimum(
            st["commit_index"][c] + rng.integers(0, 4, n), I32_MAX),
        "success": rng.random(n) < 0.8,
        "reply_next_idx": np.clip(last + rng.integers(-2, 2, n), 1, I32_MAX),
        "reply_last_idx": np.clip(last - rng.integers(-1, 2, n), 0, I32_MAX),
        "reply_last_term": term,
        "cand_last_idx": np.clip(last + rng.integers(-2, 3, n), 0, I32_MAX),
        "cand_last_term": np.clip(
            st["last_term"][c] + rng.integers(-1, 2, n), 0, I32_MAX),
        "cand_machine_version": rng.integers(0, 3, n),
        "token": st["pre_vote_token"][c],
    }
    for f, v in vals.items():
        out[R[f], :n] = v
    # host term overrides, at the previous index or the next commit point
    hint = np.flatnonzero(rng.random(n) < 0.1)
    out[R["host_term_idx"], hint] = np.where(
        rng.random(len(hint)) < 0.5, prev[hint],
        np.minimum(st["commit_index"][c[hint]] + 1, I32_MAX))
    out[R["host_term_val"], hint] = cur[hint]

    # appended runs: unique groups after the wrap (some written as
    # negative ids), half of them outside ``cols``, then pad ids
    out[R["a_gid"]] = g
    out[R["w_gid"]] = g
    na = max(1, width // 4)
    ag = rng.choice(g, size=min(na, g), replace=False)
    na = len(ag)
    hi = np.minimum(st["last_index"][ag] + rng.integers(0, 3, na), I32_MAX)
    gid = np.where(rng.random(na) < 0.2, ag - g, ag)
    out[R["a_gid"], :na] = gid
    out[R["a_lo"], :na] = np.maximum(hi - rng.integers(-2, 2 * k, na), 1)
    out[R["a_hi"], :na] = hi
    out[R["a_term"], :na] = st["current_term"][ag]
    pads = [g, g + 3, -g - 1, -2 * g]
    npad = min(len(pads), width - na)
    out[R["a_gid"], na:na + npad] = pads[:npad]
    out[R["a_lo"], na:na + npad] = 1
    out[R["a_hi"], na:na + npad] = 5
    out[R["a_term"], na:na + npad] = 9
    # watermarks: duplicates reduce by max, -1 wraps to G-1, pads drop
    nw = max(1, width // 4)
    wg = rng.choice(g, size=nw)
    wg[: nw // 4] = wg[nw // 4: 2 * (nw // 4)]  # duplicate ids
    w_gid = np.where(rng.random(nw) < 0.1, wg - g, wg)
    out[R["w_gid"], :nw] = w_gid
    out[R["w_idx"], :nw] = np.clip(
        st["last_index"][wg] + rng.integers(-3, 2, nw), 0, I32_MAX)
    npad = min(3, width - nw)
    out[R["w_gid"], nw:nw + npad] = [g, -g - 5, g + 9][:npad]
    out[R["w_idx"], nw:nw + npad] = I32_MAX
    return out.astype(np.int32)


def shard_edges(rng, st: dict, out: np.ndarray, n: int) -> np.ndarray:
    """``out``, a full-width packed mailbox (from ``packed``), with its
    scatter rows rewritten for a mesh of ``n`` equal shards: appended
    runs at the first and the last group of every shard beside others
    (a fifth written as negative aliases), then pad ids at G, G + 1 and
    below -G; watermarks at every shard edge and some others (a tenth
    as negative aliases), then pads. Each row names a group at most
    once, as the coordinator's mailboxes do."""
    g = out.shape[1]
    k = st["term_suffix"].shape[1]
    gs = g // n
    edges = np.unique(np.concatenate([np.arange(n) * gs,
                                      np.arange(n) * gs + gs - 1]))
    rest = np.setdiff1d(np.arange(g), edges)
    ag = np.concatenate([edges, rng.choice(rest, size=len(rest) // 4,
                                           replace=False)])
    rng.shuffle(ag)
    na = len(ag)
    hi = np.minimum(st["last_index"][ag] + rng.integers(0, 3, na), I32_MAX)
    out[R["a_gid"]] = g
    out[R["a_gid"], :na] = np.where(rng.random(na) < 0.2, ag - g, ag)
    out[R["a_lo"], :na] = np.maximum(hi - rng.integers(-2, 2 * k, na), 1)
    out[R["a_hi"], :na] = hi
    out[R["a_term"], :na] = st["current_term"][ag]
    pads = [g, g + 1, -g - 1][:g - na]
    out[R["a_gid"], na:na + len(pads)] = pads
    out[R["a_lo"], na:na + len(pads)] = 1
    out[R["a_hi"], na:na + len(pads)] = 5
    out[R["a_term"], na:na + len(pads)] = 9
    wg = np.concatenate([edges, rng.choice(rest, size=len(rest) // 8,
                                           replace=False)])
    rng.shuffle(wg)
    nw = len(wg)
    out[R["w_gid"]] = g
    out[R["w_gid"], :nw] = np.where(rng.random(nw) < 0.1, wg - g, wg)
    out[R["w_idx"], :nw] = np.clip(
        st["last_index"][wg] + rng.integers(-3, 2, nw), 0, I32_MAX)
    out[R["w_gid"], nw:] = -g - 5
    out[R["w_idx"], nw:] = I32_MAX
    return out


def active_set(rng, g: int, n: int, cap: int) -> np.ndarray:
    """An active-set index of ``cap`` ids: ``n`` distinct real groups
    (G-1 among them, one written as its negative alias), then pad ids at
    and past G and below -G."""
    assert 2 <= n <= min(g, cap - 2)
    real = rng.choice(g - 1, size=n - 1, replace=False)
    ids = np.sort(np.concatenate([real, [g - 1]])).astype(np.int64)
    ids[0] -= g  # a negative id that wraps to a real group
    out = np.full(cap, g, np.int64)
    out[:n] = ids
    out[n + 1::3] = g + 3
    out[n + 2::3] = -g - 2
    return out.astype(np.int32)
