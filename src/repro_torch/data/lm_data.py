"""Deterministic synthetic LM token stream, host-sharded: a numpy copy of
``repro.data.lm_data`` (the port imports nothing of the reference package).

No downloadable corpora: the stream is a seeded Markov babbler over the
model vocabulary, enough structure that cross-entropy drops during a
training run, deterministic per (seed, host, step) so every data-parallel
host generates its own shard without coordination. The same draws from the
same generators as the reference's, so the batches are array-equal within
one process: the step seed comes from ``hash(("lm", step, host_id,
n_hosts))``, which varies with ``PYTHONHASHSEED`` between processes, as the
reference's does. The batch is numpy on the host; the caller moves it to
the card.
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, *, seed: int = 0, host_id: int = 0,
                 n_hosts: int = 1, order_states: int = 64):
        self.vocab = vocab
        self.host_id = host_id
        self.n_hosts = n_hosts
        rng = np.random.default_rng(seed)
        # a small hidden-state Markov chain emitting vocab tokens
        self.trans = rng.dirichlet(np.ones(order_states) * 0.3,
                                   size=order_states)
        self.emit_logits = rng.normal(
            size=(order_states, vocab)).astype(np.float32) * 2.0
        self._emit_cdf = None

    def _emit_probs(self):
        if self._emit_cdf is None:
            z = np.exp(self.emit_logits
                       - self.emit_logits.max(1, keepdims=True))
            p = z / z.sum(1, keepdims=True)
            self._emit_cdf = np.cumsum(p, axis=1)
        return self._emit_cdf

    def batch(self, step: int, batch: int, seq: int):
        """(tokens, labels) int32 (batch, seq) for this host at this step."""
        rng = np.random.default_rng(
            (hash(("lm", step, self.host_id, self.n_hosts)) & 0x7FFFFFFF))
        cdf = self._emit_probs()
        s = rng.integers(0, self.trans.shape[0], size=batch)
        toks = np.empty((batch, seq + 1), np.int32)
        for t in range(seq + 1):
            u = rng.random(batch)
            toks[:, t] = (cdf[s] < u[:, None]).sum(axis=1)
            # advance hidden states
            tu = rng.random(batch)
            s = (np.cumsum(self.trans[s], axis=1) < tu[:, None]).sum(axis=1)
        return toks[:, :-1], toks[:, 1:]
