"""Durable per-server metadata store interface.

Holds ``current_term``, ``voted_for`` and ``last_applied`` per server UId
— the role the reference's dets-backed ``ra_log_meta`` plays (reference:
``src/ra_log_meta.erl:28-29``): term/vote changes are stored synchronously
(they gate correctness), ``last_applied`` asynchronously. ``InMemoryMeta``
backs the oracle tests; the durable file-backed store lives in
``ra_tpu_torch.log.meta_store``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class MetaApi:
    def store(self, uid: str, key: str, value: Any) -> None:
        """Async-durable store (batched; may be lost on crash)."""
        raise NotImplementedError

    def store_sync(self, uid: str, key: str, value: Any) -> None:
        """Synchronously durable store (term/vote changes)."""
        raise NotImplementedError

    def fetch(self, uid: str, key: str, default: Any = None) -> Any:
        raise NotImplementedError

    def delete(self, uid: str) -> None:
        raise NotImplementedError


class InMemoryMeta(MetaApi):
    def __init__(self) -> None:
        self._tab: Dict[str, Dict[str, Any]] = {}
        self.sync_calls = 0

    def store(self, uid: str, key: str, value: Any) -> None:
        self._tab.setdefault(uid, {})[key] = value

    def store_sync(self, uid: str, key: str, value: Any) -> None:
        self.sync_calls += 1
        self.store(uid, key, value)

    def fetch(self, uid: str, key: str, default: Any = None) -> Any:
        return self._tab.get(uid, {}).get(key, default)

    def delete(self, uid: str) -> None:
        self._tab.pop(uid, None)
