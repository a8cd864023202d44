"""Shape-bucketed execution of the batched query plane on one GPU
(DESIGN.md §7.2).

PyTorch port of ``repro.serving.executor``. A ragged stream of
micro-batches is padded up to the next power of two (floored at
``min_bucket``, capped at ``max_batch``), so every launch runs one of a few
fixed shapes. Padding lanes use the inert query ``(u=0, ts=1, te=0)``:
``te < ts`` matches nothing (core times are >= 1), so pad lanes return
empty masks and are sliced off before the download.

:class:`ShardedExecutor` keeps the reference's surface on one device:
``num_devices`` is 1, there is no mesh, and ``align`` is the identity.
Each ``run*`` method uploads the padded query operands to the index's
device, runs the batch (one B1 launch per propagation round on CUDA, the
plain round on CPU tensors), and downloads the masks of the unpadded
prefix as numpy; the rounds go into the ``propagation_rounds`` counter.

Compile accounting differs from the reference by design. The reference
counts an XLA compile per (program, bucket) shape; the port compiles
nothing per shape. Its one compile-like event is the build and load of
B1's kernel library at first use (``label_prop._library``), which the
executor counts as ``kernel_builds`` with a ``"compile"``-category
``kernel_build`` span, once per process; :meth:`compile_count` returns the
libraries loaded.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.batch_query import (DeviceIndex, batch_query,
                                          batch_query_full,
                                          batch_query_full_mixed,
                                          window_sweep)
from repro_torch.kernels import label_prop

#: Inert padding query: te < ts matches no core-time entry (cts are >= 1).
PAD_QUERY = (0, 1, 0)


def bucket_size(b: int, min_bucket: int = 8, max_batch: int = 256) -> int:
    """Smallest power-of-two bucket >= b, floored/capped to the configured
    range. ``b`` beyond ``max_batch`` is the batcher's bug, not ours."""
    if not 1 <= b <= max_batch:
        raise ValueError(f"batch size {b} outside [1, {max_batch}]")
    bucket = max(min_bucket, 1 << (b - 1).bit_length())
    return min(bucket, max_batch)


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


def _loaded_libraries() -> int:
    """Kernel libraries of the query plane built and loaded in this
    process: B1's, 0 or 1."""
    return label_prop._library.cache_info().currsize


class ShardedExecutor:
    """Runs padded query batches on one device.

    One executor per engine; stateless across calls, so it is safe to
    share between batcher worker threads: every launch goes to the calling
    thread's current stream (the legacy default stream unless the caller
    set another), where launches from several threads serialize.
    """

    def __init__(self, device="cuda", *, metrics=None, tracer=None):
        self.device = torch.device(device)
        self.num_devices = 1
        # observability sinks (DESIGN.md §11.4): the kernel library's build
        # is recorded, not inferred — a kernel_builds counter and a
        # "compile"-category trace span
        self.metrics = metrics
        self.tracer = tracer

    def _track_build(self, program: str, bucket: int, t0: float) -> None:
        """Called after a batch during which B1's library was built and
        loaded: count it and record a span covering the batch (the build
        runs synchronously inside the first launch)."""
        t1 = time.perf_counter()
        if self.metrics is not None:
            self.metrics.count("kernel_builds")
            self.metrics.count("kernel_build_label_prop")
            self.metrics.observe("kernel_build", t1 - t0)
        if self.tracer is not None:
            self.tracer.start_span(
                "kernel_build", parent=None, cat="compile", t0=t0,
                program=program, bucket=bucket, library="label_prop").end(t1)

    def _dispatch(self, fn, program: str, bucket: int, dix: DeviceIndex,
                  args, stats: dict | None):
        c0 = _loaded_libraries()
        t0 = time.perf_counter()
        rounds: dict = {}
        out = fn(dix, *args, stats=rounds)
        if _loaded_libraries() > c0:
            self._track_build(program, bucket, t0)
        got = rounds.get("rounds", [])
        if self.metrics is not None and got:
            self.metrics.count("propagation_rounds", sum(got))
        if stats is not None:
            stats.setdefault("rounds", []).extend(got)
        return out

    def _upload(self, dix: DeviceIndex, *arrays) -> list[torch.Tensor]:
        return [torch.as_tensor(a, device=dix.device) for a in arrays]

    def align(self, bucket: int) -> int:
        """Round a bucket up to a multiple of the device count: the
        identity on one device."""
        return bucket

    def final_bucket(self, b: int, min_bucket: int, max_batch: int) -> int:
        """The executed batch shape for ``b`` requests: power-of-two bucket,
        aligned to the device count. Single owner of the formula — callers
        use this for padding metrics and pass the result to ``run``."""
        return self.align(bucket_size(b, min_bucket, max_batch))

    def run(self, dix: DeviceIndex, u, ts, te, bucket: int, *,
            stats: dict | None = None) -> np.ndarray:
        """bool[B, n] membership masks for the *unpadded* prefix; on a
        stratified index ``u`` holds entry slots. ``stats["rounds"]``
        (when given) gets the batch's propagation rounds."""
        b = len(u)
        qu, qts, qte = self._upload(dix, *pad_queries(u, ts, te, bucket))
        mask = self._dispatch(batch_query, "batch_query", bucket, dix,
                              (qu, qts, qte), stats)
        # repro: ignore[hot-path-transfer] — the batch's result download
        return mask[:b].cpu().numpy()

    def run_full(self, dix: DeviceIndex, u, ts, te, bucket: int, *,
                 stats: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(bool[B, n] vertex masks, bool[B, V] version-membership masks)
        for the unpadded prefix — the EDGES/SUBGRAPH-mode batch of a per-k
        index."""
        b = len(u)
        ops = self._upload(dix, *pad_queries(u, ts, te, bucket))
        vmask, vermask = self._dispatch(batch_query_full, "batch_query_full",
                                        bucket, dix, ops, stats)
        # repro: ignore[hot-path-transfer] — the batch's result downloads
        return (vmask[:b].cpu().numpy(),
                # repro: ignore[hot-path-transfer] — ditto
                vermask[:b, :dix.num_versions].cpu().numpy())

    def run_full_mixed(self, dix: DeviceIndex, slot, ts, te, kq,
                       bucket: int, *, stats: dict | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Mixed-k full-mode batch against a *stratified* device index:
        ``slot`` is the per-query entry slot ``k_index(k) * n + u`` and
        ``kq`` the per-query k filtering the shared version arrays. Returns
        the same ``(vertex masks, version masks)`` pair as
        :meth:`run_full`."""
        b = len(slot)
        qs, qts, qte = pad_queries(slot, ts, te, bucket)
        # pad lanes are inert via te < ts; kq=0 matches no stratum either
        qkq = np.zeros(bucket, np.int32)
        qkq[:b] = np.asarray(kq, np.int32)
        vmask, vermask = self._dispatch(
            batch_query_full_mixed, "batch_query_full_mixed", bucket, dix,
            self._upload(dix, qs, qts, qte, qkq), stats)
        # repro: ignore[hot-path-transfer] — the batch's result downloads
        return (vmask[:b].cpu().numpy(),
                # repro: ignore[hot-path-transfer] — ditto
                vermask[:b, :dix.num_versions].cpu().numpy())

    def run_sweep(self, dix: DeviceIndex, u: int, ts, te, bucket: int, *,
                  stats: dict | None = None) -> np.ndarray:
        """bool[W, n] masks of one vertex (or slot) ``u`` over W windows in
        one batch; windows pad with the inert (ts=1, te=0) window."""
        w = len(ts)
        _, tsp, tep = pad_queries([u] * w, ts, te, bucket)
        mask = self._dispatch(window_sweep, "window_sweep", bucket, dix,
                              (int(u), *self._upload(dix, tsp, tep)), stats)
        # repro: ignore[hot-path-transfer] — the sweep's result download
        return mask[:w].cpu().numpy()

    @staticmethod
    def compile_count() -> int:
        """Kernel libraries the batched query plane has built and loaded in
        this process (B1's: 0 or 1). The port compiles nothing per batch
        shape, so this stays flat across buckets and after warmup."""
        return _loaded_libraries()
