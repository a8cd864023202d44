"""Clean API usage — the negatives: none of this may be flagged."""

import time


def uses_query_surface(engine, spec, pool, fn):
    r = engine.answer("wl", spec)
    f = engine.submit_spec("wl", spec)
    # ThreadPoolExecutor.submit: its first arg is a callable reference
    job = pool.submit(fn, "wl", 2, 3, 1, 9)
    return r, f, job


def counts_through_registry(metrics):
    metrics.count("hits")
    metrics.gauge("depth", 3)


def times_with_perf_counter():
    t0 = time.perf_counter()
    return time.perf_counter() - t0


def validates_with_typed_errors(dix):
    if dix.num_nodes <= 0:
        raise ValueError("the index has no forest node")
    return dix


def suppressed_assert(x):
    assert x > 0  # repro: ignore[bare-assert]
    return x


def uses_workload_keys(registry, store, engine, cache, spec_key):
    h = registry.get("wl")
    s = store.load("wl")
    engine.warmup("wl", sweep=True)
    resident = "wl" in registry
    # the result cache's 2-tuple keys are a different key space
    hit = cache.get(("wl", spec_key))
    return h, s, resident, hit
