"""Bounded, instrumented caches of built artifacts - the memory contract
of a long-lived process (from the reference's framework-neutral
``repro/core/compile_cache.py``; the port imports nothing of it).

The port keeps its ensemble runners (``core.ensemble``) here, keyed by
family fingerprint, the key CUDA graphs of a runner will use too: a
:class:`CompiledCache` is an LRU-bounded mapping with hit / miss /
eviction counters registered in a process-wide registry, and
``CompiledCache.get_or_build(key, builder)`` its entry point.  A serving
process that lives for days must not leak built artifacts; these caches
expose the churn, so the scenario server can report cache behaviour per
family (``cache_stats()`` snapshots every registered cache).

A runner holds no compiled code yet, so a hit saves only the rebuild of
a Python closure.  The reference's ``memoize``, ``get_cache`` and
``reset_stats`` come with CUDA graphs (ROADMAP queue item 6), when the
cache holds something that costs to build.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Tuple

_REGISTRY: "OrderedDict[str, CompiledCache]" = OrderedDict()
_REGISTRY_LOCK = threading.Lock()


@dataclasses.dataclass
class CacheStats:
    """Counter snapshot of one cache (cumulative)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0
    maxsize: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": self.size,
                "maxsize": self.maxsize,
                "hit_rate": round(self.hit_rate, 4)}


class CompiledCache:
    """LRU-bounded cache with instrumentation, safe under concurrent
    access (a server may build runners from worker threads).

    The builder runs *outside* the lock — compiling an executable can take
    seconds and must not serialize unrelated lookups.  Two threads racing
    on the same missing key may both build; the first insertion wins and
    the loser's artifact is dropped (building is pure, so this is only
    wasted work, never wrong results).
    """

    def __init__(self, name: str, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError(f"CompiledCache maxsize must be >= 1, "
                             f"got {maxsize}")
        self.name = name
        self.maxsize = int(maxsize)
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        with _REGISTRY_LOCK:
            _REGISTRY[name] = self

    def get_or_build(self, key, builder: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._data:
                self._hits += 1
                self._data.move_to_end(key)
                return self._data[key]
            self._misses += 1
        value = builder()
        with self._lock:
            if key in self._data:          # lost a build race: keep winner
                self._data.move_to_end(key)
                return self._data[key]
            self._data[key] = value
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self._evictions += 1
        return value

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=self._hits, misses=self._misses,
                              evictions=self._evictions,
                              size=len(self._data), maxsize=self.maxsize)


def cache_stats(prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """Snapshot of every registered cache (optionally name-filtered) —
    the figure the scenario server's ``stats()`` endpoint reports."""
    with _REGISTRY_LOCK:
        caches: Tuple[Tuple[str, CompiledCache], ...] = tuple(
            _REGISTRY.items())
    return {n: c.stats().as_dict() for n, c in caches
            if n.startswith(prefix)}

