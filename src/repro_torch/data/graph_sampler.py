"""CSR uniform neighbour sampler (GraphSAGE minibatch_lg pipeline).

A numpy copy of ``repro.data.graph_sampler`` (the port imports nothing of
the reference package): the same draws from the same ``rng``, so the same
pool and seeds give the same arrays. Builds a CSR adjacency once, then
draws layered fanout samples (25-10 style) producing the unified padded
subgraph-batch format the GNN models consume: node_feat / src / dst /
edge_mask / seed_mask, padded to static shapes (the serve step's shapes do
not change from batch to batch). The batch is numpy on the host; the
caller moves it to the card.
"""

from __future__ import annotations

import numpy as np


class CSRGraph:
    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray):
        self.n = n
        order = np.argsort(src, kind="stable")
        self.col = dst[order].astype(np.int32)
        deg = np.bincount(src, minlength=n)
        self.ptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=self.ptr[1:])

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator):
        """(len(nodes), fanout) neighbour ids, -1 padded."""
        out = np.full((nodes.shape[0], fanout), -1, np.int32)
        for i, v in enumerate(nodes):
            lo, hi = self.ptr[v], self.ptr[v + 1]
            if hi > lo:
                take = rng.integers(lo, hi, size=min(fanout, hi - lo))
                out[i, : take.shape[0]] = self.col[take]
        return out


def sample_subgraph_batch(g: CSRGraph, feats: np.ndarray, labels: np.ndarray,
                          seeds: np.ndarray, fanout: tuple,
                          rng: np.random.Generator,
                          pad_nodes: int | None = None,
                          pad_edges: int | None = None) -> dict:
    """Layered fanout sample -> padded unified GNN batch (numpy arrays)."""
    frontier = seeds.astype(np.int32)
    nodes = [frontier]
    edges_src, edges_dst = [], []
    for f in fanout:
        nb = g.sample_neighbors(frontier, f, rng)
        valid = nb >= 0
        src = nb[valid]
        dst = np.repeat(frontier, valid.sum(axis=1))
        edges_src.append(src)
        edges_dst.append(dst)
        frontier = np.unique(src)
        nodes.append(frontier)
    all_nodes = np.unique(np.concatenate(nodes))
    remap = np.full(g.n, -1, np.int64)
    remap[all_nodes] = np.arange(all_nodes.shape[0])
    # repro: ignore[int32-narrowing] — local ids < all_nodes.shape[0] <= n
    src = remap[np.concatenate(edges_src)].astype(np.int32)
    # repro: ignore[int32-narrowing] — ditto
    dst = remap[np.concatenate(edges_dst)].astype(np.int32)

    n_sub = all_nodes.shape[0]
    e_sub = src.shape[0]
    pad_nodes = pad_nodes or n_sub
    pad_edges = pad_edges or int(np.ceil(max(e_sub, 1) / 512)) * 512
    if pad_nodes < n_sub or pad_edges < e_sub:
        raise ValueError(
            f"pad budget too small: need >= ({n_sub} nodes, {e_sub} "
            f"edges), got ({pad_nodes}, {pad_edges})")

    node_feat = np.zeros((pad_nodes, feats.shape[1]), np.float32)
    node_feat[:n_sub] = feats[all_nodes]
    lab = np.zeros(pad_nodes, np.int32)
    lab[:n_sub] = labels[all_nodes]
    seed_mask = np.zeros(pad_nodes, bool)
    seed_mask[remap[seeds]] = True
    edge_mask = np.zeros(pad_edges, np.float32)
    edge_mask[:e_sub] = 1.0
    return {
        "node_feat": node_feat,
        "src": np.pad(src, (0, pad_edges - e_sub)),
        "dst": np.pad(dst, (0, pad_edges - e_sub)),
        "edge_mask": edge_mask,
        "labels": lab,
        "seed_mask": seed_mask,
    }


def random_powerlaw_graph(n: int, avg_deg: int, *, seed: int = 0):
    """Synthetic power-law graph in (src, dst) doubled edge-list form."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    pop = (np.arange(1, n + 1) ** -0.8)
    pop /= pop.sum()
    a = rng.choice(n, size=m, p=pop).astype(np.int32)
    b = rng.choice(n, size=m, p=pop).astype(np.int32)
    keep = a != b
    a, b = a[keep], b[keep]
    return np.concatenate([a, b]), np.concatenate([b, a])
