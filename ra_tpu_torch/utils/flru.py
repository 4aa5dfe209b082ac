"""Fixed-size LRU cache with an eviction handler.

Same capability as the reference's ``src/ra_flru.erl`` (used there as the
open-segment file-descriptor cache). Built on ``OrderedDict`` move-to-end
semantics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Generic, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class FLRU(Generic[K, V]):
    def __init__(self, max_size: int, on_evict: Optional[Callable[[K, V], None]] = None):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max_size = max_size
        self.on_evict = on_evict
        self._d: "OrderedDict[K, V]" = OrderedDict()

    def get(self, key: K) -> Optional[V]:
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def insert(self, key: K, value: V) -> None:
        if key in self._d:
            old = self._d.pop(key)
            if self.on_evict and old is not value:
                self.on_evict(key, old)
        self._d[key] = value
        while len(self._d) > self.max_size:
            k, v = self._d.popitem(last=False)
            if self.on_evict:
                self.on_evict(k, v)

    def evict(self, key: K) -> Optional[V]:
        if key in self._d:
            v = self._d.pop(key)
            if self.on_evict:
                self.on_evict(key, v)
            return v
        return None

    def evict_all(self) -> None:
        while self._d:
            k, v = self._d.popitem(last=False)
            if self.on_evict:
                self.on_evict(k, v)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: K) -> bool:
        return key in self._d
