"""B4 (segment sum): the port's plain version and wrapper against the JAX
reference's Pallas kernel (interpret mode) and its jnp oracle, at the
shapes of tests/test_kernels.py::TestSegmentSum and with its tolerance
(rtol = atol = 1e-4: both sides add the same f32 rows in different
orders). Out-of-range ids (-1, ids in the kernel's padded segments and
past them) add nothing on either side. The kernel itself runs only on an
NVIDIA card: its tests are in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import segment_matmul as jax_sm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402

SHAPES = [(10, 4, 3), (700, 32, 90), (1024, 128, 256), (513, 7, 1)]
TOL = 1e-4


def operands(m, d, s, kind, jdt=jnp.float32):
    """(numpy vals as jdt, numpy int32 ids): ids uniform in [0, s), or with
    -1 pads, ids just past s (inside the Pallas kernel's padded segments)
    and ids far past it."""
    rng = np.random.default_rng(m + d + s)
    vals = np.array(jnp.asarray(rng.normal(size=(m, d)), jdt))
    ids = rng.integers(0, s, m)
    if kind == "out_of_range":
        u = rng.random(m)
        ids[u < 0.1] = -1
        ids[(u >= 0.1) & (u < 0.15)] = s + 3
        ids[(u >= 0.15) & (u < 0.2)] = s + 100_000
    return vals, ids.astype(np.int32)


def pallas(vals, ids, s):
    return np.asarray(jax_sm.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                         s))


@pytest.mark.parametrize("kind", ["in_range", "out_of_range"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_segment_sum_matches_pallas_kernel(shape, kind):
    m, d, s = shape
    vals, ids = operands(m, d, s, kind)
    before = sm.segment_sum.launches
    got = ops.segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), s)
    assert sm.segment_sum.launches == before               # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (s, d)
    np.testing.assert_allclose(got.numpy(), pallas(vals, ids, s), rtol=TOL,
                               atol=TOL)
    assert torch.equal(got, ref.segment_sum(torch.as_tensor(vals),
                                            torch.as_tensor(ids), s))
    if kind == "in_range":
        want = jax_ref.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(ids),
                                          s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("m,s", [(337, 50), (2048, 1)])
def test_width_one_counts_as_the_degree(m, s):
    """d = 1 (the GNN's degree count: the edge mask summed by destination)."""
    rng = np.random.default_rng(m)
    mask = (rng.random((m, 1)) < 0.7).astype(np.float32)
    ids = rng.integers(-1, s + 2, m).astype(np.int32)
    got = ops.segment_sum(torch.as_tensor(mask), torch.as_tensor(ids), s)
    np.testing.assert_allclose(got.numpy(), pallas(mask, ids, s), rtol=TOL,
                               atol=TOL)
    ok = (ids >= 0) & (ids < s)
    want = np.bincount(ids[ok], weights=mask[ok, 0], minlength=s)
    assert np.array_equal(got[:, 0].numpy(), want.astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_values_are_summed_in_f32(shape):
    m, d, s = shape
    vals, ids = operands(m, d, s, "out_of_range", jnp.bfloat16)
    tv = torch.as_tensor(vals.astype(np.float32)).bfloat16()    # exact
    got = ops.segment_sum(tv, torch.as_tensor(ids), s)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas(vals, ids, s), rtol=TOL,
                               atol=TOL)


def test_empty_shapes():
    assert torch.equal(ops.segment_sum(torch.ones(0, 5),
                                       torch.zeros(0, dtype=torch.int32), 4),
                       torch.zeros(4, 5))
    out = ops.segment_sum(torch.ones(6, 3), torch.zeros(6, dtype=torch.int32),
                          0)
    assert out.shape == (0, 3) and out.dtype == torch.float32


def test_int64_ids_are_taken_as_int32():
    vals = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([1, 0, 1, 5])
    want = torch.tensor([[3.0, 4.0, 5.0], [6.0, 8.0, 10.0]])
    assert torch.equal(ops.segment_sum(vals, ids, 2), want)


@pytest.mark.parametrize("bad", ["rank", "int_vals", "float_ids", "length",
                                 "ids_rank", "negative", "device"])
def test_wrapper_rejects_what_it_cannot_sum(bad):
    vals, ids, s = torch.ones(6, 3), torch.zeros(6, dtype=torch.int32), 2
    if bad == "rank":
        vals = torch.ones(6)
    elif bad == "int_vals":
        vals = torch.ones(6, 3, dtype=torch.int32)
    elif bad == "float_ids":
        ids = torch.zeros(6)
    elif bad == "length":
        ids = torch.zeros(5, dtype=torch.int32)
    elif bad == "ids_rank":
        ids = torch.zeros(6, 1, dtype=torch.int32)
    elif bad == "negative":
        s = -1
    else:
        ids = torch.zeros(6, dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, TypeError)):
        sm.segment_sum(vals, ids, s)


@pytest.mark.parametrize("d,mb", [(602, 1224.4), (128, 261.4), (1, 3.4)])
def test_bound_counts_each_byte_once(d, mb):
    """GraphSAGE's three B4 calls at minibatch_lg (E = 337,920 padded
    edges, S = 169,984 nodes): vals and ids read once, out written once."""
    E, S = 337_920, 169_984
    nbytes = 4 * E * d + 4 * E + 4 * S * d
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.1)
    assert sm.segment_sum_bound_ms(E, d, S) == pytest.approx(
        nbytes / 3.35e12 * 1e3)
