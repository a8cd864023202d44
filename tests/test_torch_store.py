"""The port's persistent index store (``repro_torch.store``) and the
registry's disk tier, on the CPU (``device="cpu"``), against the JAX
package's (``repro.store``).

Every class of tests/test_store.py (blob I/O, the segment/manifest format
with its delta classes, recovery, IndexStore round trips, the registry's
write-through, promotion, demotion and warm restart) and the store crash
tests of tests/test_fault.py, held to the same semantics on the port.
Then the two packages against each other, with no tolerance: the same
commit sequence gives byte-equal segment files and manifests equal but
for ``written_at``, and each package loads the other's store into
objects equal, field for field, to its own cold build."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro.serving.registry import IndexRegistry as JaxRegistry  # noqa: E402
from repro.store import IndexStore as JaxStore  # noqa: E402
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core.query_api import TCCSQuery  # noqa: E402
from repro_torch.core.temporal_graph import gen_temporal_graph  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving import registry as registry_mod  # noqa: E402
from repro_torch.serving.metrics import EngineMetrics  # noqa: E402
from repro_torch.serving.registry import IndexRegistry  # noqa: E402
from repro_torch.store import IndexStore, StoreCorruption  # noqa: E402
from repro_torch.store import blobio  # noqa: E402
from repro_torch.store import segment as seg  # noqa: E402
from repro_torch.store.index_store import key_dirname  # noqa: E402
from test_streaming import \
    assert_pecb_identical as jax_assert_pecb  # noqa: E402
from test_torch_streaming import assert_fields_equal, split_epoch  # noqa: E402

TAB_FIELDS = ("kptr", "edge_id", "ts_from", "ts_to", "ct",
              "vptr", "v_ts_from", "v_ts_to", "v_ct")
TIMEOUT = 60


def small_graph(seed=3):
    return gen_temporal_graph(n=40, m=320, t_max=20, seed=seed)


def registry(**kw):
    return IndexRegistry(device="cpu", **kw)


def build_handle(g, name="g"):
    """One cold-built IndexHandle via a throwaway registry (no store)."""
    reg = registry()
    reg.register_graph(name, g)
    try:
        return reg.get(name)
    finally:
        reg.close()


def assert_handles_identical(a, b):
    assert_fields_equal(a.pecb, b.pecb)
    assert a.epoch == b.epoch
    for f in TAB_FIELDS:
        assert np.array_equal(getattr(a.tab, f), getattr(b.tab, f)), f
    for f in ("src", "dst", "t"):
        assert np.array_equal(getattr(a.graph, f), getattr(b.graph, f)), f


# ----------------------------------------------------------------------
# blobio
# ----------------------------------------------------------------------

class TestBlobio:
    def test_atomic_write_roundtrip_no_tmp_left(self, tmp_path):
        p = str(tmp_path / "x.bin")
        blobio.atomic_write(p, b"hello-store")
        with open(p, "rb") as f:
            assert f.read() == b"hello-store"
        assert [n for n in os.listdir(tmp_path) if "tmp" in n] == []

    def test_array_blob_roundtrip(self):
        for a in (np.arange(17, dtype=np.int32),
                  np.linspace(0, 1, 9).reshape(3, 3),
                  np.zeros(0, dtype=np.int64)):
            b = blobio.blob_array(blobio.array_blob(a))
            assert b.dtype == a.dtype and b.shape == a.shape
            assert np.array_equal(b, a)

    def test_blob_crc_failure_detected(self):
        blob = blobio.array_blob(np.arange(8, dtype=np.int32))
        raw = bytearray(blob["raw"])
        raw[3] ^= 0xFF
        blob["raw"] = bytes(raw)
        with pytest.raises(IOError, match="crc32"):
            blobio.blob_array(blob)


# ----------------------------------------------------------------------
# segment/manifest format
# ----------------------------------------------------------------------

class TestSegmentFormat:
    def _commit(self, d, epoch, arrays, prev=None, **kw):
        return seg.write_commit(str(d), {"epoch": epoch}, arrays, prev, **kw)

    def test_full_commit_roundtrip(self, tmp_path):
        arrays = {"a": np.arange(100, dtype=np.int32),
                  "b": np.linspace(0, 1, 33),
                  "c": np.arange(12, dtype=np.int64).reshape(3, 4)}
        res = self._commit(tmp_path, 0, arrays)
        assert res["mode"] == "full" and res["epoch"] == 0
        man, loaded, recovered = seg.open_latest(str(tmp_path))
        assert recovered == 0 and man["epoch"] == 0
        for name, a in arrays.items():
            got = loaded[name]
            assert got.dtype == a.dtype and got.shape == a.shape
            assert np.array_equal(got, a)

    def test_parts_are_aligned(self, tmp_path):
        arrays = {"a": np.arange(7, dtype=np.int32),
                  "b": np.arange(5, dtype=np.int64)}
        self._commit(tmp_path, 0, arrays)
        man, _, _ = seg.open_latest(str(tmp_path))
        for ent in man["arrays"].values():
            for p in ent["parts"]:
                assert p["offset"] % seg.ALIGN == 0

    def test_delta_reuse_suffix_prefix(self, tmp_path):
        a0 = {"keep": np.arange(200, dtype=np.int32),
              "grow": np.arange(300, dtype=np.int32),
              "front": np.arange(100, 300, dtype=np.int32)}
        self._commit(tmp_path, 0, a0)
        man0, arr0, _ = seg.open_latest(str(tmp_path))
        a1 = {"keep": a0["keep"],
              "grow": np.concatenate([a0["grow"],
                                      np.arange(300, 340, dtype=np.int32)]),
              "front": np.concatenate([np.arange(50, 100, dtype=np.int32),
                                       a0["front"]])}
        res = self._commit(tmp_path, 1, a1, prev=(man0, arr0))
        assert res["mode"] == "delta"
        man1, arr1, _ = seg.open_latest(str(tmp_path))
        assert man1["epoch"] == 1
        keep_parts = man1["arrays"]["keep"]["parts"]
        assert len(keep_parts) == 1
        assert keep_parts[0]["segment"] == \
            man0["arrays"]["keep"]["parts"][0]["segment"]
        grow_parts = man1["arrays"]["grow"]["parts"]
        assert len(grow_parts) == 2
        assert grow_parts[1]["segment"] != grow_parts[0]["segment"]
        front_parts = man1["arrays"]["front"]["parts"]
        assert len(front_parts) == 2
        assert front_parts[0]["segment"] != front_parts[1]["segment"]
        for name, a in a1.items():
            assert np.array_equal(arr1[name], a), name
        assert res["bytes_written"] < sum(a.nbytes for a in a1.values())

    def test_full_change_falls_back_to_full_commit(self, tmp_path):
        a0 = {"x": np.arange(64, dtype=np.int32)}
        self._commit(tmp_path, 0, a0)
        man0, arr0, _ = seg.open_latest(str(tmp_path))
        a1 = {"x": a0["x"][::-1].copy()}
        res = self._commit(tmp_path, 1, a1, prev=(man0, arr0))
        assert res["mode"] == "full"
        _, arr1, _ = seg.open_latest(str(tmp_path))
        assert np.array_equal(arr1["x"], a1["x"])

    def test_chain_bound_forces_compaction(self, tmp_path):
        arrays = {"grow": np.arange(512, dtype=np.int32),
                  "pad": np.arange(4096, dtype=np.int32)}
        self._commit(tmp_path, 0, arrays)
        modes = []
        for e in range(1, 6):
            prev = seg.open_latest(str(tmp_path))
            arrays = {"grow": np.concatenate(
                          [arrays["grow"], np.arange(8, dtype=np.int32)]),
                      "pad": arrays["pad"]}
            res = self._commit(tmp_path, e, arrays, prev=(prev[0], prev[1]),
                               max_chain=3, keep_manifests=10)
            modes.append(res["mode"])
        assert "full" in modes and modes[0] == "delta"
        first_full = modes.index("full")
        assert all(m == "delta" for m in modes[:first_full])
        man, loaded, _ = seg.open_latest(str(tmp_path))
        assert np.array_equal(loaded["grow"], arrays["grow"])
        assert len(man["segments"]) <= 4

    def test_gc_drops_old_manifests_and_orphans(self, tmp_path):
        for e in range(4):
            self._commit(tmp_path, e,
                         {"x": np.arange(32 + e, dtype=np.int32)},
                         keep_manifests=2)
        names = os.listdir(tmp_path)
        assert len([n for n in names if n.startswith("manifest_")]) == 2
        kept_segs = {n for n in names if n.startswith("seg_")}
        man, _, _ = seg.open_latest(str(tmp_path))
        assert set(man["segments"]) <= kept_segs
        assert len(kept_segs) == 2

    def test_next_seq_never_reuses_orphans(self, tmp_path):
        self._commit(tmp_path, 0, {"x": np.arange(8, dtype=np.int32)})
        (tmp_path / "seg_00000007.bin").write_bytes(b"orphan")
        assert seg.next_seq(str(tmp_path)) == 8


class TestSegmentRecovery:
    def _two_commits(self, d):
        a0 = {"x": np.arange(256, dtype=np.int32)}
        seg.write_commit(str(d), {"epoch": 0}, a0)
        a1 = {"x": np.arange(256, 512, dtype=np.int32)}
        seg.write_commit(str(d), {"epoch": 1}, a1)
        return a0, a1

    def test_corrupt_newest_segment_recovers_previous(self, tmp_path):
        a0, _ = self._two_commits(tmp_path)
        man, _, _ = seg.open_latest(str(tmp_path))
        target = tmp_path / man["arrays"]["x"]["parts"][0]["segment"]
        raw = bytearray(target.read_bytes())
        raw[5] ^= 0xFF
        target.write_bytes(bytes(raw))
        man2, loaded, recovered = seg.open_latest(str(tmp_path))
        assert man2["epoch"] == 0 and recovered == 1
        assert np.array_equal(loaded["x"], a0["x"])
        with pytest.raises(StoreCorruption, match="crc32"):
            seg.load_arrays(str(tmp_path), man)

    def test_truncated_manifest_recovers_previous(self, tmp_path):
        a0, _ = self._two_commits(tmp_path)
        newest = seg.list_manifests(str(tmp_path))[0][1]
        p = tmp_path / newest
        p.write_bytes(p.read_bytes()[:20])
        man, loaded, recovered = seg.open_latest(str(tmp_path))
        assert man["epoch"] == 0 and recovered == 1
        assert np.array_equal(loaded["x"], a0["x"])

    def test_missing_segment_recovers_previous(self, tmp_path):
        a0, _ = self._two_commits(tmp_path)
        man, _, _ = seg.open_latest(str(tmp_path))
        os.remove(tmp_path / man["arrays"]["x"]["parts"][0]["segment"])
        man2, loaded, recovered = seg.open_latest(str(tmp_path))
        assert man2["epoch"] == 0 and recovered == 1
        assert np.array_equal(loaded["x"], a0["x"])

    def test_stray_tmp_files_ignored(self, tmp_path):
        _, a1 = self._two_commits(tmp_path)
        (tmp_path / "seg_00000009.bin.tmp-123").write_bytes(b"partial")
        (tmp_path / "manifest_00000009.json.tmp-123").write_bytes(b"{")
        man, loaded, recovered = seg.open_latest(str(tmp_path))
        assert man["epoch"] == 1 and recovered == 0
        assert np.array_equal(loaded["x"], a1["x"])

    def test_empty_dir_is_a_miss(self, tmp_path):
        assert seg.open_latest(str(tmp_path)) is None
        assert seg.open_latest(str(tmp_path / "absent")) is None


# ----------------------------------------------------------------------
# IndexStore: handle <-> segment round trip
# ----------------------------------------------------------------------

class TestIndexStore:
    def test_put_load_roundtrip(self, tmp_path):
        g = small_graph()
        h = build_handle(g)
        store = IndexStore(str(tmp_path))
        res = store.put_handle("g", h)
        assert res["mode"] == "full" and res["epoch"] == 0
        assert store.current_epoch("g") == 0
        assert store.keys() == ["g"]
        stored = store.load("g")
        assert stored is not None and stored.recovered == 0
        assert_fields_equal(stored.pecb, h.pecb)
        assert_fields_equal(stored.tab, h.tab)
        for f in ("src", "dst", "t"):
            assert np.array_equal(getattr(stored.graph, f), getattr(g, f))
        assert set(stored.load_stages) == {"open", "assemble"}
        st = store.stats()
        assert st["commits"] == 1 and st["commits_full"] == 1
        assert st["loads"] == 1 and st["load_bytes"] > 0

    def test_put_same_epoch_is_noop(self, tmp_path):
        h = build_handle(small_graph())
        store = IndexStore(str(tmp_path))
        store.put_handle("g", h)
        res = store.put_handle("g", h)
        assert res["mode"] == "current" and res["bytes_written"] == 0
        assert store.stats()["commits_noop"] == 1

    def test_load_miss_returns_none(self, tmp_path):
        store = IndexStore(str(tmp_path))
        assert store.load("nope") is None
        assert store.current_epoch("nope") is None

    def test_key_dirname_sanitized_and_collision_proof(self):
        d1 = key_dirname("feed@2026/08")
        d2 = key_dirname("feed@2026_08")
        assert "/" not in d1 and d1 != d2

    def test_stored_answers_match_live_index(self, tmp_path):
        g = small_graph(seed=9)
        h = build_handle(g)
        store = IndexStore(str(tmp_path))
        store.put_handle("g", h)
        stored = store.load("g")
        rng = np.random.default_rng(0)
        for _ in range(25):
            u = int(rng.integers(0, g.n))
            ts = int(rng.integers(1, g.t_max))
            te = int(rng.integers(ts, g.t_max + 1))
            q = TCCSQuery(u, ts, te, 2)
            assert stored.pecb.answer(q).vertices == h.pecb.answer(q).vertices


# ----------------------------------------------------------------------
# registry disk tier: write-through, promote, demote, warm restart
# ----------------------------------------------------------------------

class TestRegistryDiskTier:
    def test_build_writes_through_then_promotes_on_restart(self, tmp_path):
        g = small_graph(seed=5)
        store_a = IndexStore(str(tmp_path))
        reg_a = registry(store=store_a)
        reg_a.register_graph("w", g)
        h_a = reg_a.get("w")
        reg_a.close()
        assert h_a.source == "build"
        assert store_a.stats()["commits"] == 1

        reg_b = registry(store=IndexStore(str(tmp_path)))
        reg_b.register_graph("w", g)
        h_b = reg_b.get("w")
        reg_b.close()
        assert h_b.source == "disk"
        assert reg_b.builds == 0 and reg_b.promotions == 1
        assert_handles_identical(h_b, h_a)
        # the promoted mirror on the registry's device equals a fresh
        # upload of the cold-built index, array for array
        fresh = bq.to_device(h_a.pecb, "cpu")
        for f in bq._ARRAY_FIELDS:
            assert torch.equal(getattr(h_b.device, f), getattr(fresh, f)), f
        assert set(h_b.build_stages) == {"open", "assemble", "device"}
        assert h_b.build_seconds == pytest.approx(
            sum(h_b.build_stages.values()))
        st = reg_b.stats()
        assert (st["promotions"], st["store_load_failures"],
                st["store_commit_failures"]) == (1, 0, 0)

    def test_stale_store_falls_back_to_cold_build(self, tmp_path):
        reg_a = registry(store=IndexStore(str(tmp_path)))
        reg_a.register_graph("w", small_graph(seed=5))
        reg_a.get("w")
        reg_a.close()
        reg_b = registry(store=IndexStore(str(tmp_path)))
        reg_b.register_graph("w", small_graph(seed=6))
        h = reg_b.get("w")
        reg_b.close()
        assert h.source == "build"
        assert reg_b.promotions == 0 and reg_b.builds == 1

    def test_evict_demotes_and_promote_counts_metrics(self, tmp_path):
        metrics = EngineMetrics()
        store = IndexStore(str(tmp_path), metrics=metrics)
        reg = registry(capacity=1, metrics=metrics, store=store)
        reg.register_graph("a", small_graph(seed=1))
        reg.register_graph("b", small_graph(seed=2))
        h_a = reg.get("a")
        reg.get("b")
        assert "a" not in reg
        assert reg.stats()["demotions"] == 1
        h_a2 = reg.get("a")
        reg.close()
        assert h_a2.source == "disk"
        assert reg.promotions == 1 and reg.builds == 2
        assert_handles_identical(h_a2, h_a)
        snap = metrics.snapshot(include_sources=False)["counters"]
        assert snap["evictions_demoted"] == 2
        assert snap["promotions"] == 1
        assert snap.get("demote_bytes", 0) == 0
        assert snap["store_commits"] == 2 and snap["store_loads"] >= 1

    def test_epoch_lifecycle_deltas_and_warm_reopen(self, tmp_path):
        g = small_graph(seed=7)
        g0, suffix = split_epoch(g, 0.7)
        store = IndexStore(str(tmp_path))
        reg = registry(store=store)
        reg.register_graph("feed", g0)
        reg.get("feed")
        for fut in reg.extend_graph("feed", suffix).values():
            fut.result(timeout=TIMEOUT)
        t_cut = max(2, g.t_max // 4)
        for fut in reg.retain("feed", t_cut).values():
            fut.result(timeout=TIMEOUT)
        h_live = reg.get("feed")
        g_final = reg.resolve_graph("feed")
        reg.close()
        assert h_live.epoch == 2
        st = store.stats()
        assert st["commits"] == 3
        assert st["commits_delta"] >= 1

        # warm reopen WITHOUT register_graph: resolve_graph adopts the
        # stored graph + epoch, the build promotes the stored index
        reg2 = registry(store=IndexStore(str(tmp_path)))
        h2 = reg2.get("feed")
        assert h2.source == "disk" and h2.epoch == 2
        assert_handles_identical(h2, h_live)
        g2 = reg2.resolve_graph("feed")
        assert np.array_equal(g2.t, g_final.t)
        # promote, then ingest a day: the promoted (mmap-backed, read-only)
        # arrays are the base of the extend; equal to a cold build
        nxt = g2.t_max + 1
        futs = reg2.extend_graph(
            "feed", [(int(g2.src[0]), int(g2.dst[0]), nxt)])
        h3 = futs["feed"].result(timeout=TIMEOUT)
        reg2.close()
        assert h3.epoch == 3 and h3.pecb.t_max == nxt
        h_cold = build_handle(reg2.resolve_graph("feed"))
        assert_fields_equal(h3.pecb, h_cold.pecb)
        fresh = bq.to_device(h_cold.pecb, "cpu")
        for f in bq._ARRAY_FIELDS:
            assert torch.equal(getattr(h3.device, f), getattr(fresh, f)), f

        # the delta-chained commits replay to a cold-build-identical index
        fresh_store = IndexStore(str(tmp_path)).load("feed")
        assert fresh_store.epoch == 3
        assert_fields_equal(fresh_store.pecb, h_cold.pecb)

    @pytest.mark.parametrize("host_threshold", [10**9, 0],
                             ids=["host_route", "device_route"])
    def test_promoted_handle_stamps_disk_provenance(self, tmp_path,
                                                    host_threshold):
        g = small_graph(seed=11)
        cfg = EngineConfig(store_dir=str(tmp_path), flush_ms=1.0,
                           host_threshold=host_threshold)
        q = TCCSQuery(0, 1, g.t_max, 2)
        with ServingEngine(cfg, device="cpu") as eng:
            eng.register_graph("w", g)
            eng.warmup("w")
            first = eng.answer("w", q)
            assert first.provenance.route != "disk"
        with ServingEngine(cfg, device="cpu") as eng:
            eng.register_graph("w", g)
            eng.warmup("w")
            res = eng.answer("w", q)
            assert res.provenance.route == "disk"
            assert res.vertices == first.vertices
            want = "pecb" if host_threshold else "pecb-device"
            assert res.provenance.backend == want
            stats = eng.stats()
            assert stats["registry"]["promotions"] == 1
            assert stats["store"]["loads"] >= 1
            snap = eng.metrics.snapshot()
            assert snap["sources"]["store"]["commits_noop"] >= 0
            assert "index_promote" in snap["latency"]

    def test_store_failure_degrades_to_build(self, tmp_path):
        class BrokenStore(IndexStore):
            def load(self, key):
                raise OSError("disk on fire")

            def put_handle(self, key, handle, prev=None):
                raise OSError("disk on fire")

        metrics = EngineMetrics()
        reg = registry(store=BrokenStore(str(tmp_path)), metrics=metrics)
        reg.register_graph("w", small_graph(seed=4))
        h = reg.get("w")
        reg.close()
        assert h.source == "build" and reg.builds == 1
        snap = metrics.snapshot(include_sources=False)["counters"]
        assert snap["store_load_failures"] == 1
        assert snap["store_commit_failures"] == 1
        st = reg.stats()
        assert (st["store_load_failures"], st["store_commit_failures"]) == (
            1, 1)

    def test_failed_upload_of_promoted_index_raises(self, tmp_path,
                                                    monkeypatch):
        """A device failing to take a promoted index is not a store
        failure: the build raises instead of rebuilding and uploading
        again (nothing hides a fault of the device)."""
        g = small_graph(seed=5)
        reg = registry(store=IndexStore(str(tmp_path)))
        reg.register_graph("w", g)
        reg.get("w")
        reg.close()

        def broken(index, device="cuda"):
            raise RuntimeError("upload failed")

        monkeypatch.setattr(registry_mod, "to_device", broken)
        reg = registry(store=IndexStore(str(tmp_path)))
        reg.register_graph("w", g)
        with pytest.raises(RuntimeError, match="upload failed"):
            reg.get("w")
        reg.close()
        assert reg.builds == 0 and reg.promotions == 0
        assert reg.stats()["store_load_failures"] == 0


# ----------------------------------------------------------------------
# crash recovery (tests/test_fault.py's TestStoreCrashRecovery)
# ----------------------------------------------------------------------

class TestStoreCrashRecovery:
    KEY = "crash"

    @pytest.fixture(scope="class")
    def committed(self, tmp_path_factory):
        """Two committed epochs (cold full + suffix-ingest delta) with the
        live handles that produced them."""
        root = str(tmp_path_factory.mktemp("store-src"))
        g = gen_temporal_graph(n=40, m=320, t_max=20, seed=13)
        g0, suffix = split_epoch(g, 0.7)
        reg = registry(store=IndexStore(root))
        reg.register_graph(self.KEY, g0)
        h0 = reg.get(self.KEY)
        h1 = reg.extend_graph(self.KEY, suffix)[self.KEY].result(
            timeout=TIMEOUT)
        g1 = reg.resolve_graph(self.KEY)
        reg.close()
        return root, h0, h1, g0, g1

    def _wreck(self, committed, tmp_path):
        root = str(tmp_path / "store")
        shutil.copytree(committed[0], root)
        return root, os.path.join(root, key_dirname(self.KEY))

    def _reopen(self, root, graph=None):
        reg = registry(store=IndexStore(root))
        if graph is not None:
            reg.register_graph(self.KEY, graph)
        try:
            return reg, reg.get(self.KEY)
        finally:
            reg.close()

    def _manifests(self, d):
        return sorted(n for n in os.listdir(d) if n.startswith("manifest_"))

    def test_killed_mid_segment_write_is_ignored(self, committed, tmp_path):
        root, d = self._wreck(committed, tmp_path)
        with open(os.path.join(d, "seg_00000003.bin.tmp-999"), "wb") as f:
            f.write(b"\x00" * 100)
        with open(os.path.join(d, "seg_00000003.bin"), "wb") as f:
            f.write(b"\x00" * 100)
        reg, h = self._reopen(root)
        assert h.source == "disk" and h.epoch == 1
        assert_fields_equal(h.pecb, committed[2].pecb)
        assert seg.next_seq(d) >= 4

    def test_truncated_manifest_recovers_prior_epoch(self, committed,
                                                     tmp_path):
        root, d = self._wreck(committed, tmp_path)
        with open(os.path.join(d, self._manifests(d)[-1]), "r+b") as f:
            f.truncate(25)
        reg, h = self._reopen(root)
        assert h.source == "disk" and h.epoch == 0
        assert_fields_equal(h.pecb, committed[1].pecb)

    def test_corrupted_segment_crc_recovers_prior_epoch(self, committed,
                                                        tmp_path):
        root, d = self._wreck(committed, tmp_path)
        mans = self._manifests(d)
        with open(os.path.join(d, mans[0])) as f:
            base_segs = set(json.load(f)["segments"])
        with open(os.path.join(d, mans[-1])) as f:
            delta_segs = set(json.load(f)["segments"]) - base_segs
        assert delta_segs, "epoch 1 should have written its own segment"
        target = os.path.join(d, sorted(delta_segs)[0])
        with open(target, "r+b") as f:
            f.seek(7)
            byte = f.read(1)
            f.seek(7)
            f.write(bytes([byte[0] ^ 0xFF]))
        store = IndexStore(root)
        reg = registry(store=store)
        reg.register_graph(self.KEY, committed[3])
        h = reg.get(self.KEY)
        reg.close()
        assert h.source == "disk" and h.epoch == 0
        assert_fields_equal(h.pecb, committed[1].pecb)
        assert store.stats()["recovered_commits"] == 1

    def test_lost_latest_pointer_is_harmless(self, committed, tmp_path):
        root, d = self._wreck(committed, tmp_path)
        os.remove(os.path.join(d, "latest"))
        reg, h = self._reopen(root)
        assert h.source == "disk" and h.epoch == 1
        assert_fields_equal(h.pecb, committed[2].pecb)

    def test_total_loss_falls_back_to_cold_build(self, committed, tmp_path):
        root, d = self._wreck(committed, tmp_path)
        for name in os.listdir(d):
            if name.startswith("seg_"):
                os.remove(os.path.join(d, name))
        reg, h = self._reopen(root, graph=committed[4])
        assert h.source == "build" and reg.builds == 1
        assert_fields_equal(h.pecb, committed[2].pecb)

    def test_recovered_store_keeps_committing(self, committed, tmp_path):
        root, d = self._wreck(committed, tmp_path)
        with open(os.path.join(d, self._manifests(d)[-1]), "r+b") as f:
            f.truncate(10)
        store = IndexStore(root)
        reg = registry(store=store)
        reg.register_graph(self.KEY, committed[3])
        assert reg.get(self.KEY).epoch == 0
        g0, g1 = committed[3], committed[4]
        suffix = [(int(u), int(v), int(t)) for u, v, t in
                  zip(g1.src[g0.m:], g1.dst[g0.m:], g1.t[g0.m:])]
        h1b = reg.extend_graph(self.KEY, suffix)[self.KEY].result(
            timeout=TIMEOUT)
        reg.close()
        assert h1b.epoch == 1
        stored = IndexStore(root).load(self.KEY)
        assert stored.epoch == 1
        assert_fields_equal(stored.pecb, committed[2].pecb)


# ----------------------------------------------------------------------
# the two packages against each other: one on-disk format
# ----------------------------------------------------------------------

CROSS = dict(n=40, m=320, t_max=20, seed=17)
CROSS_KEY = "feed"
STEPS = ("cold", "ingest", "trim")


def lifecycle(reg, g, t_cut):
    """The handles of one commit sequence: the cold build of the graph's
    first 70%, the suffix ingest, one trim."""
    g0, suffix = split_epoch(g, 0.7)
    reg.register_graph(CROSS_KEY, g0)
    hs = [reg.get(CROSS_KEY)]
    hs.append(reg.extend_graph(CROSS_KEY, suffix)[CROSS_KEY].result(
        timeout=TIMEOUT))
    hs.append(reg.retain(CROSS_KEY, t_cut)[CROSS_KEY].result(
        timeout=TIMEOUT))
    return hs


def key_files(root) -> dict:
    d = os.path.join(root, key_dirname(CROSS_KEY))
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """Both packages run the same lifecycle. ``registries``: each
    registry wrote its own store through (the write-through path).
    ``files``: each package's ``put_handle`` committed its handles with
    ``prev=`` for deltas, build seconds zeroed (the one meta value a run
    measures), the key directory read back after every commit."""
    t_cut = max(2, CROSS["t_max"] // 4)
    roots = {p: str(tmp_path_factory.mktemp(f"reg-{p}"))
             for p in ("port", "ref")}
    reg = registry(store=IndexStore(roots["port"]))
    port_hs = lifecycle(reg, gen_temporal_graph(**CROSS), t_cut)
    port_graph = reg.resolve_graph(CROSS_KEY)
    reg.close()
    jreg = JaxRegistry(store=JaxStore(roots["ref"]))
    ref_hs = lifecycle(jreg, jax_gen(**CROSS), t_cut)
    jreg.close()

    files, modes = {}, {}
    for p, store_cls, hs in (("port", IndexStore, port_hs),
                             ("ref", JaxStore, ref_hs)):
        store = store_cls(str(tmp_path_factory.mktemp(f"put-{p}")))
        prev, files[p], modes[p] = None, [], []
        for h in hs:
            h = dataclasses.replace(h, build_seconds=0.0)
            modes[p].append(store.put_handle(CROSS_KEY, h, prev=prev)["mode"])
            files[p].append(key_files(store.root))
            prev = h
    return dict(roots=roots, port_hs=port_hs, ref_hs=ref_hs, files=files,
                modes=modes, port_graph=port_graph)


def test_commit_modes_match_the_reference(cross):
    assert cross["modes"]["port"] == cross["modes"]["ref"]
    assert cross["modes"]["port"][:2] == ["full", "delta"]


@pytest.mark.parametrize("step", range(len(STEPS)), ids=STEPS)
def test_segment_files_are_byte_equal(cross, step):
    port, ref = cross["files"]["port"][step], cross["files"]["ref"][step]
    assert sorted(port) == sorted(ref)
    for name in port:
        if name.startswith("seg_") or name == "latest":
            assert port[name] == ref[name], name


@pytest.mark.parametrize("step", range(len(STEPS)), ids=STEPS)
def test_manifests_equal_but_written_at(cross, step):
    port, ref = cross["files"]["port"][step], cross["files"]["ref"][step]
    names = [n for n in port if n.startswith("manifest_")]
    assert names
    for name in names:
        a, b = json.loads(port[name]), json.loads(ref[name])
        a.pop("written_at")
        b.pop("written_at")
        assert a == b, name


def test_reference_store_loads_through_the_port(cross):
    """The reference registry's store, loaded by the port, equals the
    port's own cold build of the final graph field for field; the port's
    registry promotes it and its mirror equals a fresh upload."""
    stored = IndexStore(cross["roots"]["ref"]).load(CROSS_KEY)
    assert stored.epoch == 2
    cold = build_handle(cross["port_graph"])
    assert_fields_equal(stored.pecb, cold.pecb)
    assert_fields_equal(stored.tab, cold.tab)
    for f in ("src", "dst", "t"):
        assert np.array_equal(getattr(stored.graph, f),
                              getattr(cross["port_graph"], f))
    reg = registry(store=IndexStore(cross["roots"]["ref"]))
    h = reg.get(CROSS_KEY)
    reg.close()
    assert h.source == "disk" and h.epoch == 2
    fresh = bq.to_device(cold.pecb, "cpu")
    for f in bq._ARRAY_FIELDS:
        assert torch.equal(getattr(h.device, f), getattr(fresh, f)), f


def test_port_store_loads_through_the_reference(cross):
    """The port registry's store, loaded by the reference, is
    bit-identical to the reference's live handle of the same epoch."""
    stored = JaxStore(cross["roots"]["port"]).load(CROSS_KEY)
    live = cross["ref_hs"][-1]
    assert stored.epoch == live.epoch == 2
    jax_assert_pecb(stored.pecb, live.pecb)
    for f in TAB_FIELDS:
        assert np.array_equal(getattr(stored.tab, f), getattr(live.tab, f))
