"""Seeded API-discipline violations — parsed by tests, never imported."""

import time


def uses_legacy_shims(index, engine):
    a = index.query(3, 1, 9)                 # deprecated-shim (3-arg query)
    b = engine.submit("wl", 2, 3, 1, 9)      # deprecated-shim (5-arg submit)
    c = engine.submit_many("wl", 2, [(3, 1, 9)])   # deprecated-shim
    return a, b, c


def mutates_counters(metrics):
    metrics._counters["hits"] = 7            # metrics-direct
    metrics._gauges["depth"] += 1            # metrics-direct


def times_with_wallclock():
    return time.time()                       # wallclock-in-traced


def has_bare_assert(dix):
    assert dix.num_nodes > 0                 # bare-assert
    return dix


def uses_per_k_keys(registry, store, engine, k):
    h1 = registry.get(("wl", 3))             # per-k-key (tuple key)
    h2 = store.load(("wl", k))               # per-k-key (tuple key)
    h3 = registry.get_nowait("wl", k)        # per-k-key (positional k)
    h4 = engine.prefetch("wl", 2)            # per-k-key (positional k)
    resident = ("wl", k) not in registry     # per-k-key (tuple membership)
    return h1, h2, h3, h4, resident
