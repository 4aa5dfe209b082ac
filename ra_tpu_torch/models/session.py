"""Session/lock-service machine: TTL leases, monitor-driven expiry,
lock acquire/release/steal with fencing tokens.

Capability model: the reference's lock/lease patterns on top of ra
(session processes monitored by the machine, leases re-armed through
machine ``Timer`` effects, locks fenced by a monotonically increasing
token so a paused ex-holder can never overwrite a newer holder's
writes). This is the workload that stresses timer effects and monitor
cleanup in ways kv/fifo cannot — which is exactly why it lands together
with the deterministic simulation plane (docs/INTERNALS.md §19) that
can explore its interleavings.

Commands:
  ("session_open", sid, ttl_ms)        -- open (or renew if open)
  ("session_renew", sid)               -- extend the lease one TTL
  ("session_close", sid)               -- clean close, locks released
  ("lock_acquire", sid, key[, "steal"]) -- grant / queue / steal
  ("lock_release", sid, key)
  ("down", sid, info)                  -- builtin monitor DOWN
  ("timeout", ("session", sid, gen))   -- builtin machine-timer fire

Determinism contract: apply NEVER reads a clock. A lease's lapse is the
arrival of its ``("timeout", ("session", sid, gen))`` command — armed
via a ``Timer`` effect whose name carries the lease GENERATION, so a
renewal (gen bump) makes any in-flight older timer a provable no-op.
Every expiry in the replicated history is therefore attributable to
exactly one cause: a matching-generation timeout command (TTL lapse) or
a ``down`` command (monitor fired) — the property the lock-safety
oracle asserts.

Fencing: every grant (acquire, steal, handoff) draws a fresh token from
a per-machine monotonic counter. "Never two live holders" is structural
(one owner per key in the map); the client-visible half is "tokens per
key strictly increase", so a stale holder's token can always be fenced.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Dict, Optional, Set, Tuple

from ra_tpu_torch.effects import Demonitor, Monitor, ReleaseCursor, SendMsg, Timer
from ra_tpu_torch.machine import Machine


@dataclasses.dataclass
class Session:
    ttl_ms: int
    gen: int  # lease generation; bumped on every renew/reopen


@dataclasses.dataclass
class SessionState:
    sessions: "OrderedDict[Any, Session]" = dataclasses.field(
        default_factory=OrderedDict
    )
    # key -> (owner_sid, fencing_token)
    locks: "OrderedDict[Any, Tuple[Any, int]]" = dataclasses.field(
        default_factory=OrderedDict
    )
    # key -> waiting sids in arrival order
    waiters: Dict[Any, deque] = dataclasses.field(default_factory=dict)
    next_token: int = 0

    def clone(self) -> "SessionState":
        return SessionState(
            sessions=OrderedDict(
                (k, Session(s.ttl_ms, s.gen)) for k, s in self.sessions.items()
            ),
            locks=OrderedDict(self.locks),
            waiters={k: deque(v) for k, v in self.waiters.items()},
            next_token=self.next_token,
        )

    def held_by(self, sid) -> list:
        return [k for k, (o, _t) in self.locks.items() if o == sid]


class SessionMachine(Machine):
    """``ctr`` is an optional ``Counters`` vector (``SESSION_FIELDS``);
    only ONE instance in a replicated fold should carry it, or every
    replica's apply bumps the same event three times."""

    def __init__(self, ctr=None):
        self.ctr = ctr

    def _c(self, field: str, n: int = 1) -> None:
        if self.ctr is not None:
            self.ctr.incr(field, n)

    def init(self, config) -> SessionState:
        return SessionState()

    # -- apply ----------------------------------------------------------

    def apply(self, meta, cmd, state: SessionState):
        if not isinstance(cmd, tuple) or not cmd:
            return state, None
        op = cmd[0]
        if op == "session_open":
            return self._open(meta, cmd, state)
        if op == "session_renew":
            return self._renew(meta, cmd, state)
        if op == "session_close":
            return self._close(meta, cmd, state)
        if op == "lock_acquire":
            return self._acquire(meta, cmd, state)
        if op == "lock_release":
            return self._release(meta, cmd, state)
        if op == "down":
            _, sid, _info = cmd
            if sid in state.sessions:
                st = state.clone()
                effects = self._expire(meta, st, sid, "down")
                return st, ("ok", None), effects
            return state, ("ok", None)
        if op == "timeout":
            name = cmd[1]
            if (isinstance(name, tuple) and len(name) == 3
                    and name[0] == "session"):
                _, sid, gen = name
                sess = state.sessions.get(sid)
                if sess is not None and sess.gen == gen:
                    st = state.clone()
                    effects = self._expire(meta, st, sid, "ttl")
                    return st, ("ok", None), effects
            # stale generation (renewed since armed) or unknown: no-op
            return state, ("ok", None)
        if op in ("nodeup", "nodedown", "machine_version"):
            return state, None
        return state, ("error", "unknown_op")

    # -- session lifecycle ----------------------------------------------

    def _open(self, meta, cmd, state: SessionState):
        _, sid, ttl_ms = cmd
        st = state.clone()
        effects = []
        sess = st.sessions.get(sid)
        if sess is None:
            st.sessions[sid] = sess = Session(int(ttl_ms), 1)
            effects.append(Monitor("process", sid, "machine"))
            self._c("session_opens")
        else:
            # reopening an open session is a renewal with a new TTL
            sess.ttl_ms = int(ttl_ms)
            sess.gen += 1
            self._c("session_renews")
        effects.append(Timer(("session", sid, sess.gen), sess.ttl_ms))
        return st, ("ok", sess.gen), effects

    def _renew(self, meta, cmd, state: SessionState):
        _, sid = cmd
        sess = state.sessions.get(sid)
        if sess is None:
            return state, ("error", "unknown_session")
        st = state.clone()
        sess = st.sessions[sid]
        sess.gen += 1
        self._c("session_renews")
        return st, ("ok", sess.gen), [
            Timer(("session", sid, sess.gen), sess.ttl_ms)
        ]

    def _close(self, meta, cmd, state: SessionState):
        _, sid = cmd
        if sid not in state.sessions:
            return state, ("error", "unknown_session")
        st = state.clone()
        sess = st.sessions.pop(sid)
        effects = [
            # cancel the armed lease timer and stop watching the owner
            Timer(("session", sid, sess.gen), None),
            Demonitor("process", sid, "machine"),
        ]
        self._drop_holder(st, sid, effects)
        self._c("session_closes")
        self._maybe_release_cursor(meta, st, effects)
        return st, ("ok", None), effects

    def _expire(self, meta, st: SessionState, sid, cause: str) -> list:
        """Shared by TTL lapse and monitor DOWN — the ONLY two paths
        that may remove a session without its own close command."""
        sess = st.sessions.pop(sid)
        effects = [
            Timer(("session", sid, sess.gen), None),
            Demonitor("process", sid, "machine"),
            SendMsg(sid, ("session_expired", sid, sess.gen, cause),
                    ("ra_event",)),
        ]
        self._drop_holder(st, sid, effects)
        self._c("session_expiries_ttl" if cause == "ttl"
                else "session_expiries_down")
        self._maybe_release_cursor(meta, st, effects)
        return effects

    # -- locks -----------------------------------------------------------

    def _acquire(self, meta, cmd, state: SessionState):
        _, sid, key = cmd[:3]
        steal = len(cmd) > 3 and cmd[3] == "steal"
        if sid not in state.sessions:
            return state, ("error", "unknown_session")
        st = state.clone()
        effects = []
        held = st.locks.get(key)
        if held is None:
            token = self._grant(st, key, sid)
            self._c("session_lock_acquires")
            return st, ("ok", "acquired", token), effects
        owner, token = held
        if owner == sid:
            return st, ("ok", "held", token), effects
        if steal:
            new_token = self._grant(st, key, sid)
            # the deposed holder learns its token is fenced out
            effects.append(SendMsg(owner, ("lock_lost", key, token),
                                   ("ra_event",)))
            q = st.waiters.get(key)
            if q is not None and sid in q:
                q.remove(sid)
                if not q:
                    st.waiters.pop(key)
            self._c("session_lock_steals")
            return st, ("ok", "stolen", new_token), effects
        q = st.waiters.setdefault(key, deque())
        if sid not in q:
            q.append(sid)
        self._c("session_lock_waits")
        return st, ("ok", "queued", None), effects

    def _release(self, meta, cmd, state: SessionState):
        _, sid, key = cmd
        held = state.locks.get(key)
        if held is None or held[0] != sid:
            return state, ("error", "not_holder")
        st = state.clone()
        effects = []
        del st.locks[key]
        self._handoff(st, key, effects)
        self._c("session_lock_releases")
        self._maybe_release_cursor(meta, st, effects)
        return st, ("ok", None), effects

    def _grant(self, st: SessionState, key, sid) -> int:
        st.next_token += 1
        st.locks[key] = (sid, st.next_token)
        return st.next_token

    def _drop_holder(self, st: SessionState, sid, effects) -> None:
        """Remove a departing session from every lock and wait queue,
        handing each released key to its next live waiter."""
        for key in st.held_by(sid):
            del st.locks[key]
            self._handoff(st, key, effects)
        for key in list(st.waiters):
            q = st.waiters[key]
            if sid in q:
                q.remove(sid)
            if not q:
                st.waiters.pop(key)

    def _handoff(self, st: SessionState, key, effects) -> None:
        q = st.waiters.get(key)
        while q:
            nxt = q.popleft()
            if nxt in st.sessions:
                token = self._grant(st, key, nxt)
                effects.append(SendMsg(nxt, ("lock_granted", key, token),
                                       ("ra_event",)))
                self._c("session_lock_handoffs")
                break
        if q is not None and not q:
            st.waiters.pop(key, None)

    def _maybe_release_cursor(self, meta, st: SessionState, effects) -> None:
        # everything settled: nothing in the log before here is needed
        # to rebuild the (empty) state
        if not st.sessions and not st.locks and not st.waiters:
            effects.append(ReleaseCursor(meta["index"], st))

    # -- runtime hooks ----------------------------------------------------

    def state_enter(self, role: str, state: SessionState):
        """A fresh leader re-arms every open lease's timer and re-issues
        the monitors: machine timers and monitors are leader-local
        runtime state, lost on failover (reference: ra_machine
        state_enter effects)."""
        if role != "leader":
            return []
        effects = []
        for sid, sess in state.sessions.items():
            effects.append(Monitor("process", sid, "machine"))
            effects.append(Timer(("session", sid, sess.gen), sess.ttl_ms))
        return effects

    def overview(self, state: SessionState):
        return {
            "type": "session",
            "sessions": len(state.sessions),
            "locks": len(state.locks),
            "waiters": sum(len(q) for q in state.waiters.values()),
            "next_token": state.next_token,
        }
