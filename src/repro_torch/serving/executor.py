"""Shape-bucketed execution of the batched query plane on one GPU
(DESIGN.md §7.2).

PyTorch port of ``repro.serving.executor``. A ragged stream of
micro-batches is padded up to the next power of two (floored at
``min_bucket``, capped at ``max_batch``), so every launch runs one of a few
fixed shapes. Padding lanes use the inert query ``(u=0, ts=1, te=0)``:
``te < ts`` matches nothing (core times are >= 1), so pad lanes return
empty masks and are sliced off before the download.

Each ``run*`` function uploads the padded query operands to the index's
device, runs the batch, and downloads the masks of the unpadded prefix as
numpy. ``stats`` (a dict the caller owns) collects the propagation rounds
of each batch. The reference's multi-device mesh and compile counting
have no counterpart yet: this executor drives one GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.batch_query import (DeviceIndex, batch_query,
                                          batch_query_full_mixed,
                                          window_sweep)

#: Inert padding query: te < ts matches no core-time entry (cts are >= 1).
PAD_QUERY = (0, 1, 0)


def bucket_size(b: int, min_bucket: int = 8, max_batch: int = 256) -> int:
    """Smallest power-of-two bucket >= b, floored/capped to the configured
    range. ``b`` beyond ``max_batch`` is the caller's bug."""
    if not 1 <= b <= max_batch:
        raise ValueError(f"batch size {b} outside [1, {max_batch}]")
    bucket = max(min_bucket, 1 << (b - 1).bit_length())
    return min(bucket, max_batch)


def final_bucket(b: int, min_bucket: int = 8, max_batch: int = 256) -> int:
    """The executed batch shape for ``b`` requests; callers pass it to the
    ``run*`` functions. On one GPU it is the power-of-two bucket."""
    return bucket_size(b, min_bucket, max_batch)


def pad_queries(u, ts, te, bucket: int):
    """int32[(bucket,)] x3, padded with the inert query."""
    u = np.asarray(u, np.int32)
    ts = np.asarray(ts, np.int32)
    te = np.asarray(te, np.int32)
    b = u.shape[0]
    if b > bucket:
        raise ValueError(f"batch of {b} queries exceeds bucket {bucket}")
    if b == bucket:
        return u, ts, te
    pad = bucket - b
    return (
        np.concatenate([u, np.full(pad, PAD_QUERY[0], np.int32)]),
        np.concatenate([ts, np.full(pad, PAD_QUERY[1], np.int32)]),
        np.concatenate([te, np.full(pad, PAD_QUERY[2], np.int32)]),
    )


def _upload(dix: DeviceIndex, *arrays):
    return tuple(torch.as_tensor(a, device=dix.device) for a in arrays)


def run(dix: DeviceIndex, u, ts, te, bucket: int, *,
        stats: dict | None = None) -> np.ndarray:
    """bool[b, n] membership masks for the ``b`` unpadded queries; on a
    stratified index ``u`` holds entry slots."""
    b = len(u)
    qu, qts, qte = _upload(dix, *pad_queries(u, ts, te, bucket))
    mask = batch_query(dix, qu, qts, qte, stats=stats)
    return mask[:b].cpu().numpy()


def run_full_mixed(dix: DeviceIndex, slot, ts, te, kq, bucket: int, *,
                   stats: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(bool[b, n] vertex masks, bool[b, V] version masks) of a mixed-k
    batch against a stratified index: ``slot`` is each query's entry slot
    ``k_index(k) * n + u`` and ``kq`` its k."""
    b = len(slot)
    qs, qts, qte = pad_queries(slot, ts, te, bucket)
    # pad lanes are inert via te < ts; kq=0 matches no stratum either
    qkq = np.zeros(bucket, np.int32)
    qkq[:b] = np.asarray(kq, np.int32)
    vmask, vermask = batch_query_full_mixed(
        dix, *_upload(dix, qs, qts, qte, qkq), stats=stats)
    return (vmask[:b].cpu().numpy(),
            vermask[:b, :dix.num_versions].cpu().numpy())


def run_sweep(dix: DeviceIndex, u: int, ts, te, bucket: int, *,
              stats: dict | None = None) -> np.ndarray:
    """bool[W, n] masks of one vertex (or slot) ``u`` over W windows in
    one batch; windows pad with the inert (ts=1, te=0) window."""
    w = len(ts)
    _, tsp, tep = pad_queries([u] * w, ts, te, bucket)
    qts, qte = _upload(dix, tsp, tep)
    mask = window_sweep(dix, int(u), qts, qte, stats=stats)
    return mask[:w].cpu().numpy()
