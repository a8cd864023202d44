"""The port's checkpoint manager (``repro_torch.checkpoint``) on the CPU,
held to the semantics of tests/test_fault.py's checkpoint tests (round
trip, retention, async save, no partial file visible, restore onto a
named device) and to the reference manager's round trip of the same numpy
leaves. The file formats differ by design: the reference pickles a JAX
treedef, the port a structure of its own."""

import collections
import os
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import \
    CheckpointManager as JaxManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import flatten, unflatten  # noqa: E402
from repro_torch.configs import get as get_arch  # noqa: E402
from repro_torch.configs import cell_model_cfg  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

CPU = torch.device("cpu")


def leaves_of(tree):
    out: list = []
    flatten(tree, out)
    return out


def assert_trees_equal(got, want):
    """Same structure (container types included) and bit-equal leaves of
    the same dtype."""
    gl, wl = [], []
    assert flatten(got, gl) == flatten(want, wl)
    for a, b in zip(gl, wl):
        b = torch.as_tensor(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)


def test_roundtrip_and_crc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.ones(5), {"b": torch.zeros(2)}],
            "pair": (torch.arange(3), torch.tensor([True, False]))}
    mgr.save(10, tree, {"note": "hi"})
    step, restored, meta = mgr.restore(device="cpu")
    assert step == 10 and meta["note"] == "hi"
    assert_trees_equal(restored, tree)
    assert all(leaf.device == CPU for leaf in leaves_of(restored))


def test_crc_failure_detected_on_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(8, dtype=torch.int32)})
    path = tmp_path / "step_0000000001.ckpt"
    payload = pickle.loads(path.read_bytes())
    raw = bytearray(payload["blobs"][0]["raw"])
    raw[3] ^= 0xFF
    payload["blobs"][0]["raw"] = bytes(raw)
    path.write_bytes(pickle.dumps(payload))
    with pytest.raises(IOError, match="crc32"):
        mgr.restore(device="cpu")


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(3) * s})
    ckpts = [p for p in os.listdir(tmp_path) if p.endswith(".ckpt")]
    assert len(ckpts) == 2
    assert mgr.latest_step() == 4
    assert torch.equal(mgr.restore(3, device="cpu")[1]["x"],
                       torch.full((3,), 3.0))


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.ones(4)
    mgr.save_async(5, {"x": x})
    x.add_(1.0)            # the snapshot was taken before save_async returned
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(device="cpu")[1]["x"], torch.ones(4))


def test_async_save_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    shutil.rmtree(tmp_path / "ckpt")     # the worker's write must fail
    mgr.save_async(1, {"x": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        mgr.wait()
    mgr.wait()             # the error was handed over once


def test_atomic_no_partial_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(3)})
    with open(os.path.join(str(tmp_path), "step_0000000002.tmp-999"),
              "w") as f:
        f.write("garbage")
    assert mgr.latest_step() == 1
    assert [n for n in os.listdir(tmp_path) if ".tmp-" in n] == [
        "step_0000000002.tmp-999"]


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(device="cpu")


def test_restore_onto_named_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": torch.arange(8.0)})
    _, restored, _ = mgr.restore(device=torch.device("cpu"))
    assert restored["w"].device == CPU
    assert torch.equal(restored["w"], torch.arange(8.0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64, torch.int64, torch.uint8])
def test_dtypes_roundtrip_bit_equal(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(5, 7, generator=gen) * 100).to(dtype)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x, "strided": x.t()})
    _, got, _ = mgr.restore(device="cpu")
    for name, want in (("x", x), ("strided", x.t())):
        assert got[name].dtype == dtype
        assert torch.equal(got[name].view(torch.uint8),
                           want.contiguous().view(torch.uint8)), name


def test_model_state_dict_roundtrip(tmp_path):
    """A graphsage-reddit smoke model's state_dict (an OrderedDict) comes
    back as one, bit-equal, and loads into a fresh model."""
    spec = get_arch("graphsage-reddit")
    cfg = cell_model_cfg(spec, "minibatch_lg", smoke=True)
    model = gnn.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    sd = model.state_dict()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, sd)
    _, got, _ = mgr.restore(device="cpu")
    assert isinstance(got, collections.OrderedDict)
    assert_trees_equal(got, sd)
    fresh = gnn.GraphSAGE(cfg, device="cpu")
    fresh.load_state_dict(got)
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), sd.values()))


def test_same_numpy_leaves_as_the_reference(tmp_path):
    """The same numpy leaves through both managers: both round trips give
    the leaves back bit-equal, dtype for dtype. Keys are in sorted order,
    the order JAX flattens a dict in."""
    rng = np.random.default_rng(4)
    tree = {"ids": rng.integers(-5, 5, 9).astype(np.int32),
            "nested": [rng.normal(size=4), {"m": np.arange(3, dtype=np.int64)}],
            "step": np.int32(7),
            "w": rng.normal(size=(6, 3)).astype(np.float32)}
    JaxManager(str(tmp_path / "ref")).save(1, tree)
    CheckpointManager(str(tmp_path / "port")).save(1, tree)
    _, ref_tree, _ = JaxManager(str(tmp_path / "ref")).restore()
    _, port_tree, _ = CheckpointManager(str(tmp_path / "port")).restore(
        device="cpu")
    ref_leaves, port_leaves = [], []
    flatten(ref_tree, ref_leaves)
    flatten(port_tree, port_leaves)
    want = leaves_of(tree)
    assert len(ref_leaves) == len(port_leaves) == len(want)
    for r, p, w in zip(ref_leaves, port_leaves, want):
        w = np.asarray(w)
        assert np.asarray(r).dtype == w.dtype == p.numpy().dtype
        assert np.array_equal(np.asarray(r), w)
        assert np.array_equal(p.numpy(), w)


def test_flatten_unflatten_keep_structure():
    tree = collections.OrderedDict(
        a=[1, (2.5, {"b": np.zeros(2)})], c=({},), d=[])
    leaves: list = []
    spec = flatten(tree, leaves)
    assert len(leaves) == 3
    back = unflatten(spec, leaves)
    assert isinstance(back, collections.OrderedDict)
    assert isinstance(back["a"][1], tuple) and back["c"] == ({},)
    assert back["d"] == [] and back["a"][0] == 1
