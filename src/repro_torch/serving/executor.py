"""Shape-bucketed, device-sharded execution of the batched query plane
(DESIGN.md §7.2, §7.6).

PyTorch port of ``repro.serving.executor``. A ragged stream of
micro-batches is padded up to the next power of two (floored at
``min_bucket``, capped at ``max_batch``), so every launch runs one of a few
fixed shapes. Padding lanes use the inert query ``(u=0, ts=1, te=0)``:
``te < ts`` matches nothing (core times are >= 1), so pad lanes return
empty masks and are sliced off before the download.

:class:`ShardedExecutor` splits each padded batch over a list of devices,
as the reference splits it over its 1-D ``('batch',)`` mesh. By default
the list is every visible card, each once (``torch.device("cuda")``, one
shard, when none is visible: the first launch then raises, and nothing
falls back to the CPU). Each shard holds its own replica of the index
(``IndexHandle.replicas``); a device may stand in the list more than
once, each entry a shard with its own replica. Buckets are aligned to
the shard count (the reference's formula), and a bucket of ``B`` queries
is cut into ``d`` contiguous slices of ``B / d``: slice ``i`` is uploaded
to replica ``i``, the shards propagate in lockstep (one B1 launch per
round on each shard still changing, then its flag read;
``batch_query.run_sharded``), and the masks of the unpadded prefix are
downloaded and concatenated in slice order. A slice that holds pad
lanes only is not run: its rows are never returned. The rounds of every
shard go into the ``propagation_rounds`` counter (= B1 launches), and
each shard's into ``propagation_rounds_shard<i>``.

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

from repro_torch.core.batch_query import DeviceIndex, run_sharded
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


def _device(d) -> torch.device:
    """``d`` as a device; a bare ``cuda`` names the current card when one
    is visible, so that lists compare equal however they were spelled."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return d


def shard_devices(devices=None, device=None) -> tuple[torch.device, ...]:
    """The shards of an executor or a registry, in order. ``devices`` is
    the reference's spelling: a list (a device may repeat, each entry a
    shard with its own replica) or one device; ``device`` is the
    one-device spelling. By default every visible card, each once, or
    ``cuda`` (one shard) when none is visible."""
    if devices is not None and device is not None:
        raise ValueError("pass devices= or device=, not both")
    if device is not None:
        devices = [device]
    elif devices is None:
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(count)]
                   if count else [torch.device("cuda")])
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = tuple(_device(d) for d in devices)
    if not out:
        raise ValueError("no devices to shard over")
    return out


class ShardedExecutor:
    """Runs padded query batches split over a list of devices.

    One executor per engine; stateless across calls, so it is safe to
    share between batcher worker threads: every launch goes to the
    calling thread's current stream on its shard's device (the legacy
    default stream unless the caller set another), where launches from
    several threads serialize.
    """

    def __init__(self, devices=None, *, device=None, metrics=None,
                 tracer=None):
        self.devices = shard_devices(devices, device)
        self.device = self.devices[0]
        self.num_devices = len(self.devices)
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

    def _replicas(self, replicas) -> tuple[DeviceIndex, ...]:
        """The handle's replicas, one per shard (a lone DeviceIndex is the
        one replica of a one-shard executor)."""
        if isinstance(replicas, DeviceIndex):
            replicas = (replicas,)
        replicas = tuple(replicas)
        if len(replicas) != self.num_devices:
            raise ValueError(f"{len(replicas)} index replica(s) for "
                             f"{self.num_devices} shard(s)")
        return replicas

    def _dispatch(self, program: str, bucket: int, replicas, b: int,
                  operands, stats: dict | None, scalar=None) -> list:
        """Cut the padded host ``operands`` (each of length ``bucket``)
        into one contiguous slice per shard, upload each slice to its
        replica's device, run ``program`` on every shard that holds a
        query of the unpadded prefix ``b``, and return their outputs in
        slice order. ``scalar`` (the sweep's vertex) goes to every
        shard."""
        replicas = self._replicas(replicas)
        if self.align(bucket) != bucket:
            raise ValueError(f"bucket {bucket} is not device-aligned; "
                             "use final_bucket()")
        per = bucket // self.num_devices
        live = max(1, -(-b // per))  # shards holding a query of the prefix
        calls = []
        for i, rep in enumerate(replicas[:live]):
            ops = self._upload(rep, *(a[i * per:(i + 1) * per]
                                      for a in operands))
            calls.append((rep, *([scalar] if scalar is not None else []),
                          *ops))
        c0 = _loaded_libraries()
        t0 = time.perf_counter()
        outs, rounds = run_sharded(program, calls)
        if _loaded_libraries() > c0:
            self._track_build(program, bucket, t0)
        rounds += [0] * (self.num_devices - live)
        if self.metrics is not None and any(rounds):
            self.metrics.count("propagation_rounds", sum(rounds))
            if self.num_devices > 1:
                for i, r in enumerate(rounds):
                    self.metrics.count(f"propagation_rounds_shard{i}", r)
        if stats is not None:
            stats.setdefault("rounds", []).extend(r for r in rounds if r)
            stats.setdefault("shard_rounds", []).append(rounds)
        return outs

    @staticmethod
    def _upload(dix: DeviceIndex, *arrays) -> list[torch.Tensor]:
        return [torch.as_tensor(np.ascontiguousarray(a), device=dix.device)
                for a in arrays]

    @staticmethod
    def _download(outs, b: int, cols: int | None = None) -> np.ndarray:
        """The shards' masks concatenated in slice order, cut to the
        unpadded prefix ``b`` (and to ``cols`` columns when given)."""
        got, left = [], b
        for m in outs:
            take = min(left, m.shape[0])
            part = m[:take] if cols is None else m[:take, :cols]
            # repro: ignore[hot-path-transfer] — the batch's result download
            got.append(part.cpu().numpy())
            left -= take
        return got[0] if len(got) == 1 else np.concatenate(got)

    def align(self, bucket: int) -> int:
        """Round a bucket up to a multiple of the device count (no-op for
        power-of-two device counts <= bucket, the common case)."""
        d = self.num_devices
        if d <= 1 or bucket % d == 0:
            return bucket
        return ((bucket + d - 1) // d) * d

    def final_bucket(self, b: int, min_bucket: int, max_batch: int) -> int:
        """The executed batch shape for ``b`` requests: power-of-two bucket,
        aligned to the device count. Single owner of the formula — callers
        use this for padding metrics and pass the result to ``run``."""
        return self.align(bucket_size(b, min_bucket, max_batch))

    def run(self, replicas, u, ts, te, bucket: int, *,
            stats: dict | None = None) -> np.ndarray:
        """bool[B, n] membership masks for the *unpadded* prefix; on a
        stratified index ``u`` holds entry slots. ``replicas`` is the
        handle's, one per shard; ``bucket`` must come from
        ``final_bucket`` (already device-aligned). ``stats["rounds"]``
        (when given) gets each shard's propagation rounds and
        ``stats["shard_rounds"]`` the batch's rounds by shard."""
        b = len(u)
        outs = self._dispatch("batch_query", bucket, replicas, b,
                              pad_queries(u, ts, te, bucket), stats)
        return self._download(outs, b)

    def run_full(self, replicas, u, ts, te, bucket: int, *,
                 stats: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(bool[B, n] vertex masks, bool[B, V] version-membership masks)
        for the unpadded prefix — the EDGES/SUBGRAPH-mode batch of a per-k
        index."""
        b = len(u)
        outs = self._dispatch("batch_query_full", bucket, replicas, b,
                              pad_queries(u, ts, te, bucket), stats)
        V = self._replicas(replicas)[0].num_versions
        return (self._download([v for v, _ in outs], b),
                self._download([m for _, m in outs], b, V))

    def run_full_mixed(self, replicas, slot, ts, te, kq,
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
        outs = self._dispatch("batch_query_full_mixed", bucket, replicas, b,
                              (qs, qts, qte, qkq), stats)
        V = self._replicas(replicas)[0].num_versions
        return (self._download([v for v, _ in outs], b),
                self._download([m for _, m in outs], b, V))

    def run_sweep(self, replicas, u: int, ts, te, bucket: int, *,
                  stats: dict | None = None) -> np.ndarray:
        """bool[W, n] masks of one vertex (or slot) ``u`` over W windows in
        one batch; windows pad with the inert (ts=1, te=0) window and
        split over the shards like ``run``'s queries."""
        w = len(ts)
        _, tsp, tep = pad_queries([u] * w, ts, te, bucket)
        outs = self._dispatch("window_sweep", bucket, replicas, w,
                              (tsp, tep), stats, scalar=int(u))
        return self._download(outs, w)

    @staticmethod
    def compile_count() -> int:
        """Kernel libraries the batched query plane has built and loaded in
        this process (B1's: 0 or 1). The port compiles nothing per batch
        shape, so this stays flat across buckets and after warmup."""
        return _loaded_libraries()
