"""Per-query LRU result cache (DESIGN.md §7.3). PyTorch port of
``repro.serving.cache`` (host code).

TCCS answers are immutable for a frozen index, so a result cache in front of
the planner is exact, never stale: key = (index key, canonical spec key),
value = the whole :class:`repro_torch.core.query_api.TCCSResult` (canonical spec,
vertices, mode payload, provenance — cache hits are re-stamped
``route="cache"`` on a copy by the engine). Canonicalization (query_api)
means every window clamped to ``[1, t_max]`` and every empty window share
one entry. Real query streams are heavily skewed (contact tracing
re-queries the same hot cases; the bench workloads draw vertices from a
Zipf), which is what makes an LRU worthwhile before any device work.

When the index registry evicts a workload's stratified index, the engine's
eviction listener calls :meth:`ResultCache.purge_index` so stale keys for
dead handles stop occupying LRU capacity (they could never be hit
*wrongly* — results are immutable — but they crowd out live entries). The
k axis lives inside the canonical spec key, not the index key, so ONE
workload-level purge clears the results of every k stratum at once — and
touches nothing cached for other workloads (regression-tested). Streaming epochs
invalidate through :meth:`purge_window`: suffix appends drop nothing (every
cached canonical window predates the append); retention trims drop exactly
the windows that touch the expired prefix and *rehome* the survivors into
the shifted timeline (DESIGN.md §10.3).

Thread-safe; the engine consults it on the submit path (caller thread) and
fills it from batcher worker threads.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

from repro_torch.obs.locks import named_lock

#: spec-key mode values whose results embed absolute timestamps / edge ids
#: (EdgeSet.t / edge_id, subgraph timestamps) — never rehomed across a
#: retention shift, always dropped (see purge_window).
_PAYLOAD_MODES = ("edges", "subgraph")


class ResultCache:
    """LRU map ``key -> TCCSResult`` with hit/miss accounting.

    ``capacity <= 0`` disables caching (every ``get`` misses, ``put`` drops).
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = named_lock("cache")
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.purges = 0
        self.rehomes = 0
        self.gated = 0
        # per-index-key epoch floor (retention trims): fills carrying an
        # older epoch are dropped inside the put lock, see raise_floor
        self._floors: dict = {}

    def get(self, key):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def raise_floor(self, index_key, epoch: int) -> None:
        """Raise the epoch floor for fills under ``index_key`` (retention
        trims, DESIGN.md §10.3): once raised, a :meth:`put` carrying an
        older ``epoch`` is dropped *inside the cache lock* — atomic with
        :meth:`purge_window` — closing the check-then-put race where a
        batch or sweep bound to a pre-trim handle finishes after the
        trim's purge+rehome and would write pre-shift windows into the
        shifted key space. A stale fill that lands *before* the floor is
        raised is safe either way: the subsequent purge/rehome treats it
        like any other resident entry. Floors only ever rise."""
        with self._lock:
            cur = self._floors.get(index_key)
            if cur is None or epoch > cur:
                self._floors[index_key] = epoch

    def put(self, key, value, *, epoch: int | None = None) -> None:
        """Store a :class:`TCCSResult` (or any immutable payload) under
        ``key``, evicting LRU entries past ``capacity`` — every capacity
        eviction increments ``evictions`` (regression-pinned: ``stats()``
        must not under-report). ``epoch`` (the handle's epoch, passed by
        the planner and the engine's sweeps) is checked against the
        index key's retention floor; below-floor fills are dropped and
        counted as ``gated``."""
        if self.capacity <= 0:
            return
        with self._lock:
            if (epoch is not None and isinstance(key, tuple)
                    and len(key) == 2):
                floor = self._floors.get(key[0])
                if floor is not None and epoch < floor:
                    self.gated += 1
                    return
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def purge_index(self, index_key) -> int:
        """Drop every entry whose key belongs to ``index_key`` (an evicted
        workload). Engine cache keys are ``(index_key, spec_key)`` tuples
        with k inside the spec key, so one call clears every k stratum's
        results; foreign-shaped keys are left alone. Returns purge count."""
        with self._lock:
            dead = [k for k in self._data
                    if isinstance(k, tuple) and len(k) == 2
                    and k[0] == index_key]
            for k in dead:
                del self._data[k]
            self.purges += len(dead)
            return len(dead)

    def purge_window(self, index_key, ts_lo: int, ts_hi: int,
                     shift: int = 0) -> int:
        """Targeted invalidation for a streaming epoch swap: drop only
        ``index_key`` entries whose canonical window intersects
        ``[ts_lo, ts_hi]``.

        *Suffix append* (``shift == 0``, range = the appended timestamps):
        every other entry stays — a window with ``te < ts_lo`` contains no
        appended edge, so its cached answer is *still exact* in the new
        epoch (this is what makes suffix epochs cheap on the serving path:
        in the common case the purge count is zero, versus
        :meth:`purge_index` dropping the key's whole working set).

        *Prefix expiry* (``shift = t_cut - 1 > 0``, range = the expired
        prefix ``[1, t_cut - 1]``): windows touching the expired prefix are
        dropped — exactly those, nothing more — but the survivors cannot
        simply stay: the retained epoch's timeline is *shifted*, so an
        untouched key ``(u, ts, te, ...)`` would collide with a different
        window of the new epoch. Surviving VERTICES/COUNT entries are
        therefore **rehomed**: re-keyed to ``(u, ts - shift, te - shift,
        ...)`` with the stored result's canonical spec shifted to match
        (exact — the surviving window projects the identical subgraph, and
        a vertex set carries no timestamps). EDGES/SUBGRAPH entries embed
        absolute timestamps and edge ids in their payloads, so they are
        dropped rather than rewritten. LRU order is preserved.

        Spec keys are ``(u, ts, te, k, mode)``; the canonical empty-window
        marker (``ts > te``) never intersects and is rehomed as-is (it is
        coordinate-free). Returns the purge count (``rehomes`` counts the
        re-keyed survivors in :meth:`stats`)."""
        with self._lock:
            if not shift:
                # suffix-append path (§9.3): delete-in-place only — the
                # common case purges nothing, and must not pay a full
                # OrderedDict rebuild per refresh on a warm cache
                dead = [k for k in self._data
                        if isinstance(k, tuple) and len(k) == 2
                        and k[0] == index_key
                        and isinstance(k[1], tuple) and len(k[1]) >= 3
                        and k[1][1] <= k[1][2]
                        and k[1][2] >= ts_lo and k[1][1] <= ts_hi]
                for k in dead:
                    del self._data[k]
                self.purges += len(dead)
                return len(dead)
            n_dead = n_rehomed = 0
            rebuilt: OrderedDict = OrderedDict()
            for k, v in self._data.items():
                if not (isinstance(k, tuple) and len(k) == 2
                        and k[0] == index_key
                        and isinstance(k[1], tuple) and len(k[1]) >= 3):
                    rebuilt[k] = v              # foreign key: untouched
                    continue
                spec = k[1]
                ts, te = spec[1], spec[2]
                if ts <= te and te >= ts_lo and ts <= ts_hi:
                    n_dead += 1                 # window touches the range
                    continue
                if shift and ts <= te:
                    if len(spec) >= 5 and spec[4] in _PAYLOAD_MODES:
                        n_dead += 1             # payload embeds timestamps
                        continue
                    new_spec = (spec[0], ts - shift, te - shift) + spec[3:]
                    q = getattr(v, "query", None)
                    if q is not None:
                        v = dataclasses.replace(
                            v, query=dataclasses.replace(
                                q, ts=ts - shift, te=te - shift))
                    rebuilt[(k[0], new_spec)] = v
                    n_rehomed += 1
                    continue
                rebuilt[k] = v                  # empty-window marker / no shift
            self._data = rebuilt
            self.purges += n_dead
            self.rehomes += n_rehomed
            return n_dead

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._data),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "purges": self.purges,
                "rehomes": self.rehomes,
                "gated": self.gated,
            }
