"""Synthetic user-history batches for MIND: a numpy copy of
``repro.data.recsys_data`` (the port imports nothing of the reference
package).

Users belong to latent taste clusters; histories draw items from a
cluster-specific Zipf slice, so multi-interest routing has real structure
to extract. The same draws from the same generators, in the same order, as
the reference's, so the batches are array-equal within one process: the
step seed comes from ``hash(("rec", step, host_id))``, which varies with
``PYTHONHASHSEED`` between processes, as the reference's does. The batch
is numpy on the host (a Python loop over the users, as the reference's);
the caller moves it to the card.
"""

from __future__ import annotations

import numpy as np


class InteractionStream:
    def __init__(self, n_items: int, hist_len: int, *, n_clusters: int = 32,
                 seed: int = 0, host_id: int = 0):
        self.n_items = n_items
        self.hist_len = hist_len
        self.n_clusters = n_clusters
        self.host_id = host_id
        rng = np.random.default_rng(seed)
        self.cluster_base = rng.integers(0, max(n_items - 1000, 1), n_clusters)

    def batch(self, step: int, batch: int) -> dict:
        """``{"hist_ids": int32 (batch, hist_len), "hist_mask": f32 ones
        (batch, hist_len), "target_id": int32 (batch,)}`` for this host at
        this step; every id lies in ``[0, n_items)``."""
        rng = np.random.default_rng(hash(("rec", step, self.host_id))
                                    & 0x7FFFFFFF)
        # each user mixes 1-3 clusters (multi-interest ground truth)
        k = rng.integers(1, 4, batch)
        hist = np.empty((batch, self.hist_len), np.int64)
        target = np.empty(batch, np.int64)
        for i in range(batch):
            cs = rng.integers(0, self.n_clusters, k[i])
            base = self.cluster_base[rng.choice(cs, self.hist_len)]
            hist[i] = (base + rng.zipf(1.8, self.hist_len)) % self.n_items
            target[i] = (self.cluster_base[rng.choice(cs)]
                         + rng.zipf(1.8)) % self.n_items
        mask = np.ones((batch, self.hist_len), np.float32)
        # the ids are taken % n_items, so int32 holds them; the int64 above
        # only absorbs the unbounded Zipf draws before the modulo
        # repro: ignore[int32-narrowing] — ids % n_items fit int32
        hist_ids = hist.astype(np.int32)
        # repro: ignore[int32-narrowing] — ditto
        target_id = target.astype(np.int32)
        return {"hist_ids": hist_ids, "hist_mask": mask,
                "target_id": target_id}
