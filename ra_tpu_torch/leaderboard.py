"""Leaderboard: zero-RPC leader discovery cache.

Process-global ``cluster_name -> (leader, members)`` map updated on every
leader change (the reference's public ``ra_leaderboard`` ETS,
``src/ra_leaderboard.erl``), so clients pick the right member without a
redirect round-trip.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ra_tpu_torch.protocol import ServerId

_lock = threading.Lock()
_tab: Dict[str, Tuple[Optional[ServerId], Tuple[ServerId, ...]]] = {}


def record(cluster_name: str, leader: Optional[ServerId], members) -> None:
    with _lock:
        _tab[cluster_name] = (leader, tuple(members))


def lookup_leader(cluster_name: str) -> Optional[ServerId]:
    got = _tab.get(cluster_name)
    return got[0] if got else None


def lookup_members(cluster_name: str) -> Tuple[ServerId, ...]:
    got = _tab.get(cluster_name)
    return got[1] if got else ()


def snapshot() -> Dict[str, Tuple[Optional[ServerId], Tuple[ServerId, ...]]]:
    """Point-in-time copy of the whole table (cluster -> (leader,
    members)) — the single data source ``api.system_overview`` joins
    commit-rate gauges against."""
    with _lock:
        return dict(_tab)


def clear(cluster_name: Optional[str] = None) -> None:
    with _lock:
        if cluster_name is None:
            _tab.clear()
        else:
            _tab.pop(cluster_name, None)


def forget_member(sid: ServerId) -> None:
    """A server was DELETED (not just stopped): drop it from every
    cluster entry, clearing the leader slot if it held it and removing
    the whole entry once no members remain. Without this the table
    never forgets deleted clusters and ``system_overview`` /
    ``cluster_health`` join against ghosts forever (deleted-cluster
    leak; the reference's ETS rows die with their owner process)."""
    with _lock:
        for cluster in list(_tab):
            leader, members = _tab[cluster]
            if sid != leader and sid not in members:
                continue
            members = tuple(m for m in members if m != sid)
            if leader == sid:
                leader = None
            if members:
                _tab[cluster] = (leader, members)
            else:
                del _tab[cluster]
