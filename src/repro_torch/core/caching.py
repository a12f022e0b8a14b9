"""BoundedCache — an ``functools.lru_cache`` workalike whose bound can be
resized at runtime and whose occupancy is inspectable (twin of
``repro.core.caching``). Bounds the per-frame-shape patch geometry cache.
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Tuple


class BoundedCache:
    """LRU memo over a function of hashable arguments; key identity matches
    ``functools.lru_cache`` (positional args plus sorted kwargs items)."""

    def __init__(self, fn: Callable, maxsize: int = 128):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self._fn = fn
        self._maxsize = int(maxsize)
        self._data: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self._hits = self._misses = self._evictions = 0
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        key = args + tuple(sorted(kwargs.items())) if kwargs else args
        with self._lock:
            if key in self._data:
                self._hits += 1
                self._data.move_to_end(key)
                return self._data[key]
            self._misses += 1
        # build outside the lock: concurrent misses on different keys must
        # not serialize; a racing duplicate build is benign (last write wins)
        value = self._fn(*args, **kwargs)
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self._maxsize:
                self._data.popitem(last=False)
                self._evictions += 1
        return value

    def resize(self, maxsize: int) -> None:
        """Change the bound; shrinking evicts oldest entries immediately."""
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        with self._lock:
            self._maxsize = int(maxsize)
            while len(self._data) > self._maxsize:
                self._data.popitem(last=False)
                self._evictions += 1

    def cache_clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._hits = self._misses = self._evictions = 0

    def cache_info(self):
        """lru_cache-shaped (hits, misses, maxsize, currsize) named tuple."""
        with self._lock:
            return functools._CacheInfo(self._hits, self._misses,
                                        self._maxsize, len(self._data))

    def values(self) -> list:
        """The cached values, least recently used first."""
        with self._lock:
            return list(self._data.values())

    def occupancy(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._data), "maxsize": self._maxsize,
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions}


def bounded_cache(maxsize: int = 128):
    """Decorator form: ``@bounded_cache(128)`` over a def, like lru_cache."""
    def wrap(fn: Callable) -> BoundedCache:
        return BoundedCache(fn, maxsize=maxsize)
    return wrap
