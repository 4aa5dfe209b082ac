"""Per-node server registry: UId <-> server name <-> cluster name.

The role of the reference's ``ra_directory`` (``src/ra_directory.erl``):
resolve a server's UId to its live proc for WAL/segment-writer event
delivery, remember registrations durably so a restarted node can recover
its servers. Durability via the node's FileMeta store (registry entries
are small).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class Directory:
    def __init__(self, meta=None):
        self._lock = threading.Lock()
        self._by_uid: Dict[str, Dict[str, Any]] = {}
        self._by_name: Dict[str, str] = {}  # server name -> uid
        self._meta = meta
        if meta is not None:
            stored = meta.fetch("__directory__", "registrations", {})
            for uid, rec in stored.items():
                self._by_uid[uid] = dict(rec)
                self._by_name[rec["name"]] = uid

    def register(self, uid: str, name: str, cluster_name: str) -> None:
        with self._lock:
            self._by_uid[uid] = {"name": name, "cluster": cluster_name}
            self._by_name[name] = uid
            self._persist()

    def unregister(self, uid: str) -> None:
        with self._lock:
            rec = self._by_uid.pop(uid, None)
            if rec:
                self._by_name.pop(rec["name"], None)
            self._persist()

    def _persist(self) -> None:
        if self._meta is not None:
            self._meta.store_sync(
                "__directory__", "registrations", dict(self._by_uid)
            )

    def uid_of(self, name: str) -> Optional[str]:
        return self._by_name.get(name)

    def name_of(self, uid: str) -> Optional[str]:
        rec = self._by_uid.get(uid)
        return rec["name"] if rec else None

    def cluster_of(self, uid: str) -> Optional[str]:
        rec = self._by_uid.get(uid)
        return rec["cluster"] if rec else None

    def registered(self) -> List[Tuple[str, str, str]]:
        return [(uid, r["name"], r["cluster"]) for uid, r in self._by_uid.items()]
