"""Sim workloads: op generators, machine factories, and oracles.

One entry per workload kind ("kv" | "fifo" | "session"). Each supplies:

- ``generate_ops(schedule)`` — the seeded external timeline (client
  commands, client downs, nemesis steps), a pure function of the
  schedule so a run replays from the schedule alone;
- a machine factory (small snapshot intervals so release cursors, log
  truncation, and therefore real snapshot transfers happen inside a
  ten-virtual-second run);
- a per-apply invariant — the workload's safety oracle, checked on
  EVERY replica at EVERY applied index by the world's recording
  wrapper. Invariants are written against what correct code can
  legitimately do, not against incidental behaviour:

  * fifo: a consumer-down requeue batch must redeliver in ascending
    msg_id order — counting both same-apply deliveries to other ready
    consumers and what stays parked at the queue head (the
    reversed-requeue failpoint violates exactly this, and a
    multi-consumer interleaving of CORRECT downs does not);
  * session: lock safety — every lock owner is a live session, fencing
    tokens per key strictly increase, and a session leaves the state
    only via its own close or an attributable expiry (a ``down``
    builtin or a matching-generation ``timeout``);
  * kv: no per-apply invariant; the cross-replica digest check in the
    world (state-machine safety: equal states at equal applied index)
    carries it.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from ra_tpu_torch.effects import SendMsg
from ra_tpu_torch.models.fifo import FifoMachine
from ra_tpu_torch.models.kv import KvMachine
from ra_tpu_torch.models.session import SessionMachine

WORKLOADS = ("kv", "fifo", "session", "kvread")

_KV_KEYS = 8
_FIFO_CONSUMERS = ("c0", "c1", "c2")
_SESSIONS = ("s0", "s1", "s2", "s3")
_LOCK_KEYS = ("lk0", "lk1", "lk2")


def make_machine(workload: str, ctr=None):
    """Machine factory for one replica. ``ctr`` (SESSION_FIELDS) goes to
    exactly one replica's machine — apply runs on every replica, so a
    shared vector would multiply every count by the cluster size."""
    if workload in ("kv", "kvread"):
        return KvMachine(snapshot_interval=24)
    if workload == "fifo":
        return FifoMachine()
    if workload == "session":
        return SessionMachine(ctr=ctr)
    raise ValueError(f"unknown workload {workload!r}")


# -- op generation -------------------------------------------------------------


def generate_ops(sched) -> List[Tuple[int, Tuple[Any, ...]]]:
    rng = random.Random((sched.seed << 4) ^ 0x4F5053)  # "OPS"
    if sched.workload == "kvread":
        return _gen_kvread_ops(sched, rng)
    gen = {
        "kv": _gen_kv,
        "fifo": _gen_fifo,
        "session": _gen_session,
    }[sched.workload]
    ops: List[Tuple[int, Tuple[Any, ...]]] = []
    # ops spread across the horizon with jittered gaps; the settle
    # window after the horizon is op-free so the cluster can quiesce
    t = 0
    gap = max(2, (2 * sched.horizon_ms) // max(1, sched.n_ops))
    for i in range(sched.n_ops):
        t += 1 + rng.randrange(gap)
        if t >= sched.horizon_ms:
            break
        ops.append((t, gen(rng, i)))
    if sched.nemesis:
        k = 0
        for t in range(300, sched.horizon_ms, 400):
            ops.append((t, ("nem", k)))
            k += 1
    ops.sort(key=lambda p: p[0])
    return ops


def _gen_kvread_ops(sched, rng: random.Random) -> List[Tuple[int, Tuple[Any, ...]]]:
    """Lease read-safety workload (docs/INTERNALS.md §20): writes to
    one key interleaved with dense consistent reads fanned across
    every node. The oracle lives in the world's reply recorder: a
    write's ack carries its raft index; a read invoked after that ack
    must observe a "seq" entry at an index >= the acked floor — the
    linearizability claim the leader lease makes. Reads land on every
    node (not just the believed leader) precisely so a deposed leader
    still inside a too-long lease window serves one and gets caught."""
    ops: List[Tuple[int, Tuple[Any, ...]]] = []
    t = 0
    gap = max(2, (2 * sched.horizon_ms) // max(1, sched.n_ops))
    for _ in range(sched.n_ops):
        t += 1 + rng.randrange(gap)
        if t >= sched.horizon_ms:
            break
        if rng.random() < 0.45:
            ops.append((t, ("cmd", ("put", "seq", 0))))  # value unused
        else:
            ops.append((t, ("read", rng.randrange(sched.nodes))))
    if sched.nemesis:
        k = 0
        for t in range(300, sched.horizon_ms, 400):
            ops.append((t, ("nem", k)))
            k += 1
    ops.sort(key=lambda p: p[0])
    return ops


def read_seq_index(state) -> int:
    """The consistent-read probe for the kvread workload: the raft
    index the "seq" key was last written at (-1 before any write).
    Module-level so a dumped schedule replays without a closure."""
    entry = state.get("seq")
    return entry[0] if entry else -1


def _gen_kv(rng: random.Random, i: int) -> Tuple[Any, ...]:
    r = rng.random()
    key = f"k{rng.randrange(_KV_KEYS)}"
    if r < 0.75:
        return ("cmd", ("put", key, i))
    if r < 0.9:
        return ("cmd", ("delete", key))
    return ("cmd", ("keys",))


def _gen_fifo(rng: random.Random, i: int) -> Tuple[Any, ...]:
    r = rng.random()
    cid = rng.choice(_FIFO_CONSUMERS)
    if r < 0.5:
        return ("cmd", ("enqueue", f"m{i}"))
    if r < 0.72:
        return ("cmd", ("checkout", cid, 1 + rng.randrange(3)))
    if r < 0.9:
        # settle a plausible id; settling a non-inflight id is a no-op
        return ("cmd", ("settle", cid, 1 + rng.randrange(max(i, 1))))
    return ("down", cid)


def _gen_session(rng: random.Random, i: int) -> Tuple[Any, ...]:
    r = rng.random()
    sid = rng.choice(_SESSIONS)
    key = rng.choice(_LOCK_KEYS)
    if r < 0.25:
        return ("cmd", ("session_open", sid, 200 + rng.randrange(1200)))
    if r < 0.4:
        return ("cmd", ("session_renew", sid))
    if r < 0.48:
        return ("cmd", ("session_close", sid))
    if r < 0.68:
        return ("cmd", ("lock_acquire", sid, key))
    if r < 0.78:
        return ("cmd", ("lock_acquire", sid, key, "steal"))
    if r < 0.9:
        return ("cmd", ("lock_release", sid, key))
    return ("down", sid)


# -- per-apply invariants (the workload oracles) --------------------------------


def invariant_for(workload: str) -> Optional[Callable]:
    return {
        "kv": None,
        "kvread": None,  # read oracle runs in the world's reply recorder
        "fifo": _fifo_invariant,
        "session": _session_invariant,
    }[workload]


def _fifo_invariant(cmd, pre, post, effs,
                    tracker: Dict[str, Any]) -> Optional[str]:
    if isinstance(cmd, tuple) and cmd and cmd[0] in ("down", "cancel"):
        cid = cmd[1]
        batch = sorted((pre.consumers.get(cid) or {}).keys())
        if len(batch) >= 2:
            # the requeued batch lands at the queue FRONT, and _service
            # may hand part (or all) of it to other ready consumers
            # within the same apply — walking the queue front in order.
            # So the observable redelivery order is: batch members among
            # this apply's delivery effects (in effect order), then the
            # batch members still parked at the queue head. Correct code
            # makes that concatenation exactly the ascending batch; the
            # reversed-requeue failpoint cannot.
            batch_set = set(batch)
            delivered = [
                e.msg[1] for e in effs
                if isinstance(e, SendMsg) and e.msg
                and e.msg[0] == "delivery" and e.msg[1] in batch_set
            ]
            head = []
            for mid, _m in post.queue:
                if mid not in batch_set:
                    break
                head.append(mid)
            if delivered + head != batch:
                return (
                    f"requeue order violated: consumer {cid} went down "
                    f"holding {batch}, redelivery order {delivered + head}"
                )
    return None


def _session_invariant(cmd, pre, post, effs,
                       tracker: Dict[str, Any]) -> Optional[str]:
    # 1. lock safety: every holder is a live session
    for key, (owner, token) in post.locks.items():
        if owner not in post.sessions:
            return f"lock {key} held by dead session {owner} (token {token})"
    # 2. fencing tokens strictly increase per key across grants
    last: Dict[Any, int] = tracker.setdefault("tokens", {})
    for key, (owner, token) in post.locks.items():
        prev = last.get(key)
        if prev is not None and token < prev:
            return f"fencing token regressed on {key}: {prev} -> {token}"
        last[key] = max(token, prev or 0)
    # 3. every expiry attributable: sessions leave only via their own
    #    close, a down builtin, or a matching-generation ttl timeout
    gone = set(pre.sessions) - set(post.sessions)
    if gone:
        op = cmd[0] if isinstance(cmd, tuple) and cmd else None
        if op not in ("session_close", "down", "timeout"):
            return f"sessions {sorted(gone)} vanished on {op!r} command"
        if op == "timeout":
            name = cmd[1]
            sid, gen = name[1], name[2]
            if gone != {sid} or pre.sessions[sid].gen != gen:
                return (
                    f"timeout {name!r} expired {sorted(gone)} "
                    f"(gen mismatch or wrong session)"
                )
    return None
