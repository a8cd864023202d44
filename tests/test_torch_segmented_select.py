"""B2 (segmented count) and the counting bisection built on it: the port's
plain versions and wrappers against the JAX reference's Pallas kernel
(interpret mode), its jnp bisection and its numpy reference.

Every output is an integer, so the tolerance is exact equality. The
kernel itself runs only on an NVIDIA card: its tests are in
test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import segmented_select as jax_ss  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segmented_select as ss  # noqa: E402


def count_inputs(kind, n, e, seed):
    """(w, seg, thr) int32: sorted (CSR) ids, unsorted ids, unsorted ids
    with -1 pads, or ids that reach past n."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, e)
    if kind == "sorted":
        seg = np.sort(seg)
    elif kind == "pads":
        seg[rng.random(e) < 0.2] = -1
    elif kind == "past_n":
        seg = rng.integers(-3, n + 5, e)
    w = rng.integers(0, 50, e)
    thr = rng.integers(0, 50, n)
    return tuple(a.astype(np.int32) for a in (w, seg, thr))


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "pads", "past_n"])
@pytest.mark.parametrize("n,e", [(70, 900), (5, 1), (33, 257)])
def test_count_matches_pallas_kernel(kind, n, e):
    w, seg, thr = count_inputs(kind, n, e, n * e + len(kind))
    want = np.asarray(jax_ss.segmented_count_le(
        jnp.asarray(w), jnp.asarray(seg), jnp.asarray(thr), n,
        slot_block=256, seg_block=32))
    got = ops.segmented_count_le(torch.as_tensor(w), torch.as_tensor(seg),
                                 torch.as_tensor(thr), n)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    brute = np.array([((seg == v) & (w <= thr[v])).sum() for v in range(n)])
    assert np.array_equal(got.numpy(), brute)


def test_count_casts_integer_operands_and_counts_no_cpu_launch():
    w, seg, thr = count_inputs("unsorted", 40, 300, 1)
    before = ss.segmented_count_le.launches
    got = ss.segmented_count_le(torch.as_tensor(w, dtype=torch.int64),
                                torch.as_tensor(seg, dtype=torch.int16),
                                torch.as_tensor(thr), 40)
    assert ss.segmented_count_le.launches == before
    want = ref.segmented_count_le(*map(torch.as_tensor, (w, seg, thr)), 40)
    assert torch.equal(got, want)


def test_count_empty_shapes():
    z = torch.zeros(0, dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.int32)
    assert torch.equal(ss.segmented_count_le(z, z, ones, 4),
                       torch.zeros(4, dtype=torch.int32))
    assert ss.segmented_count_le(torch.ones(3, dtype=torch.int32),
                                 torch.zeros(3, dtype=torch.int32), z,
                                 0).shape == (0,)


def test_count_rejects_what_the_kernel_does_not_take():
    w, seg, thr = map(torch.as_tensor, count_inputs("sorted", 10, 50, 2))
    with pytest.raises(TypeError, match="integer"):
        ss.segmented_count_le(w.float(), seg, thr, 10)
    with pytest.raises(ValueError, match="length"):
        ss.segmented_count_le(w, seg[:-1], thr, 10)
    with pytest.raises(ValueError, match="length"):
        ss.segmented_count_le(w, seg, thr, 11)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segmented_count_le(w[::2], seg[:25], thr, 10)
    with pytest.raises(ValueError, match="1-D"):
        ss.segmented_count_le(w.view(5, 10), seg.view(5, 10), thr, 10)


def kth_inputs(seed):
    """The inputs of tests/test_kernels.py::test_kth_backends_agree."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 50))
    deg = rng.integers(0, 14, n)
    seg = np.repeat(np.arange(n), deg).astype(np.int32)
    vptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=vptr[1:])
    inf = int(rng.integers(6, 60))
    w = rng.integers(0, inf + 1, int(deg.sum())).astype(np.int32)
    lo = rng.integers(0, inf + 1, n).astype(np.int32)
    return n, seg, vptr, inf, w, lo


@pytest.mark.parametrize("with_lo", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_kth_smallest_matches_reference_backends(seed, k, with_lo):
    n, seg, vptr, inf, w, lo = kth_inputs(seed)
    lo_np = lo if with_lo else None
    want = jax_ss.segmented_kth_smallest_np(w, vptr, k, inf, lo=lo_np)
    assert np.array_equal(ss.segmented_kth_smallest_np(w, vptr, k, inf,
                                                       lo=lo_np), want)
    jlo = jnp.asarray(lo if with_lo else np.zeros(n, np.int32))
    pallas = np.asarray(jax_ss.kth_smallest_pallas(
        jnp.asarray(w), jnp.asarray(seg), n, k, inf,
        lo=jlo if with_lo else None))
    steps = ss.bisection_steps(inf)
    xla = np.asarray(jax_ss.kth_smallest_csr(
        jnp.asarray(w), jlo, k, inf, steps, jnp.asarray(seg),
        jnp.asarray(vptr.astype(np.int32))))
    tw, tseg, tlo = map(torch.as_tensor, (w, seg, lo))
    got = ops.kth_smallest(tw, tseg, n, k, inf,
                           lo=tlo if with_lo else None)
    csr = ss.kth_smallest_csr(tw, tlo if with_lo else torch.zeros_like(tlo),
                              k, inf, steps, tseg, torch.as_tensor(vptr))
    for out in (got, csr):
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), want)
    assert np.array_equal(pallas, want) and np.array_equal(xla, want)


@pytest.mark.parametrize("count_fn", ["csr", "b2"])
def test_kth_smallest_csr_takes_any_counter(count_fn):
    n, seg, vptr, inf, w, lo = kth_inputs(4)
    fn = ss.count_le_csr if count_fn == "csr" else (
        lambda w, thr, seg, vptr: ss.segmented_count_le(w, seg, thr, n))
    got = ss.kth_smallest_csr(*map(torch.as_tensor, (w, lo)), 3, inf,
                              ss.bisection_steps(inf), torch.as_tensor(seg),
                              torch.as_tensor(vptr), count_fn=fn)
    want = ss.segmented_kth_smallest_np(w, vptr, 3, inf, lo=lo)
    assert np.array_equal(got.numpy(), want)


def test_bisection_steps_follow_the_reference():
    # ceil(log2(inf + 1)) + 1, and 1 when inf == 0 (kth_smallest_pallas)
    assert [ss.bisection_steps(i) for i in (0, 1, 2, 3, 194)] == \
        [1, 2, 3, 3, 9]
    w = torch.zeros(3, dtype=torch.int32)
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    assert ss.kth_smallest(w, seg, 2, 2, 0).tolist() == [0, 0]


def test_count_le_csr_equals_b2_plain_on_csr():
    n, seg, vptr, inf, w, lo = kth_inputs(5)
    tw, tseg, tlo = map(torch.as_tensor, (w, seg, lo))
    assert torch.equal(ss.count_le_csr(tw, tlo, tseg, torch.as_tensor(vptr)),
                       ss.segmented_count_le(tw, tseg, tlo, n))


def test_bound_counts_each_operand_once():
    # w and seg read per slot (8 B); thr read and out written per segment
    assert ss.bound_ms(34_948, 1_899) == pytest.approx(
        (8 * 34_948 + 8 * 1_899) / 3.35e12 * 1e3)
