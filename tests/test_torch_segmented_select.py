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


# ----------------------------------------------------------------------
# stratum_sweep: B2 redesigned, the whole sweep over a t_uv block
# ----------------------------------------------------------------------

def sweep_inputs(seed, n=None, R=None, inf=None):
    """A random pair-CSR-shaped sweep block: (tuv (R, E), seg, vptr, dst,
    inf) as numpy int32, dst never equal to its source."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 40)) if n is None else n
    deg = rng.integers(0, 12, n)
    deg[rng.integers(0, n)] = 150                 # past the register slots
    seg = np.repeat(np.arange(n), deg).astype(np.int32)
    vptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=vptr[1:])
    dst = ((seg + rng.integers(1, n, seg.shape[0])) % n).astype(np.int32)
    inf = int(rng.integers(4, 40)) if inf is None else inf
    R = int(rng.integers(1, 7)) if R is None else R
    # rows non-decreasing in ts, as _tuv_rows gives them
    tuv = np.sort(rng.integers(0, inf + 1, (R, seg.shape[0])), axis=0)
    return tuv.astype(np.int32), seg, vptr, dst, inf


def numpy_sweep(tuv, seg, vptr, dst, ks, carry, inf):
    """An independent numpy oracle of the sweep: the probe by explicit
    per-segment counts, the climb by the reference's numpy k-th smallest
    with the floor c; returns (rows (K, R, n), carry, stats (K, 2))."""
    n = vptr.shape[0] - 1
    rows = np.zeros((len(ks), tuv.shape[0], n), np.int32)
    carry = carry.copy()
    stats = np.zeros((len(ks), 2), np.int64)
    for i, k in enumerate(ks):
        c = carry[i].astype(np.int64)
        for r in range(tuv.shape[0]):
            while True:
                w = np.maximum(tuv[r], c[dst])
                cnt = np.array([(w[vptr[v]:vptr[v + 1]] <= c[v]).sum()
                                for v in range(n)])
                stats[i, 0] += 1
                if ((cnt >= k) | (c >= inf)).all():
                    break
                stats[i, 1] += 1
                c = jax_ss.segmented_kth_smallest_np(w, vptr, k, inf, lo=c)
            rows[i, r] = c
        carry[i] = c
    return rows, carry, stats


@pytest.mark.parametrize("seed", range(6))
def test_stratum_sweep_plain_matches_numpy_oracle(seed):
    tuv, seg, vptr, dst, inf = sweep_inputs(seed)
    n = vptr.shape[0] - 1
    ks = [1, 2, 3, 5, 13]
    rng = np.random.default_rng(seed + 100)
    carry = np.minimum(rng.integers(0, 3, (len(ks), n)), inf).astype(np.int32)
    want_rows, want_carry, want_stats = numpy_sweep(tuv, seg, vptr, dst, ks,
                                                    carry, inf)
    tcarry = torch.as_tensor(carry.copy())
    before = ss.stratum_sweep.launches
    rows, stats = ss.stratum_sweep(*map(torch.as_tensor, (tuv, seg, vptr, dst)),
                                   torch.tensor(ks, dtype=torch.int32), tcarry,
                                   inf)
    assert ss.stratum_sweep.launches == before          # CPU: no launch
    assert rows.dtype == torch.int32 and stats.dtype == torch.int64
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(tcarry.numpy(), want_carry)
    assert np.array_equal(stats.numpy(), want_stats)
    # every (k, ts) ends on a passing probe: one probe more than climbs
    assert (stats[:, 0] - stats[:, 1] == tuv.shape[0]).all()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_only_failing_vertices_move_in_a_climb(seed, k):
    """The fact the kernel's fused probe + climb relies on: under the
    clamped update (the reference's Pallas bisection with floor c), a
    vertex that passes the probe keeps c_v, and one that fails rises by at
    least 1, to the least x > c_v with count(w <= x) >= k (inf when its
    segment has fewer than k slots)."""
    tuv, seg, vptr, dst, inf = sweep_inputs(seed, R=1)
    n = vptr.shape[0] - 1
    rng = np.random.default_rng(seed)
    c = rng.integers(0, inf + 1, n).astype(np.int32)
    w = np.maximum(tuv[0], c[dst])
    new = np.asarray(jax_ss.kth_smallest_pallas(
        jnp.asarray(w), jnp.asarray(seg), n, k, inf, lo=jnp.asarray(c)))
    for v in range(n):
        sw = w[vptr[v]:vptr[v + 1]]
        passes = (sw <= c[v]).sum() >= k or c[v] >= inf
        if passes:
            assert new[v] == c[v], v
        elif sw.shape[0] < k:
            assert new[v] == inf, v
        else:
            assert new[v] > c[v], v
            assert (sw <= new[v]).sum() >= k > (sw <= new[v] - 1).sum(), v


def test_plain_sweep_raises_past_its_probe_bound():
    """A (k, ts) fixpoint takes at most n * inf + 1 probes; past that the
    plain version raises (the kernel traps). Only an input whose seg and
    vptr disagree gets there: vertex 2's slot is probed against vertex 0's
    c, so vertex 2 fails every probe while its climb leaves it where it
    is."""
    tuv = torch.tensor([[1, 5]], dtype=torch.int32)
    seg = torch.tensor([0, 0], dtype=torch.int32)
    vptr = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    dst = torch.tensor([2, 1], dtype=torch.int32)
    carry = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="did not converge in 16 probes"):
        ss.stratum_sweep(tuv, seg, vptr, dst,
                         torch.tensor([1], dtype=torch.int32), carry, 5)


def test_stratum_sweep_writes_into_a_slice_of_its_rows():
    tuv, seg, vptr, dst, inf = sweep_inputs(7, R=3)
    n = vptr.shape[0] - 1
    ks = torch.tensor([2, 3], dtype=torch.int32)
    rows = torch.full((2, 6, n), -7, dtype=torch.int32)
    carry = torch.zeros((2, n), dtype=torch.int32)
    args = [*map(torch.as_tensor, (tuv, seg, vptr, dst)), ks]
    got, _ = ss.stratum_sweep(*args, carry, inf, out=rows[:, 2:5])
    assert got.data_ptr() == rows[:, 2:5].data_ptr()
    want, _ = ss.stratum_sweep(*args, torch.zeros((2, n), dtype=torch.int32),
                               inf)
    assert torch.equal(rows[:, 2:5], want)
    assert (rows[:, :2] == -7).all() and (rows[:, 5:] == -7).all()


def test_stratum_sweep_empty_shapes():
    tuv, seg, vptr, dst, inf = sweep_inputs(3, R=2)
    n = vptr.shape[0] - 1
    args = list(map(torch.as_tensor, (tuv, seg, vptr, dst)))
    none = torch.zeros(0, dtype=torch.int32)
    out, stats = ss.stratum_sweep(*args, none, torch.zeros((0, n),
                                                           dtype=torch.int32),
                                  inf)
    assert out.shape == (0, 2, n) and stats.shape == (0, 2)
    ks = torch.tensor([2], dtype=torch.int32)
    out, stats = ss.stratum_sweep(args[0][:0], *args[1:], ks,
                                  torch.zeros((1, n), dtype=torch.int32), inf)
    assert out.shape == (1, 0, n) and stats.tolist() == [[0, 0]]
    # no slot: every vertex climbs to inf once, then each ts probes once
    carry = torch.zeros((1, 4), dtype=torch.int32)
    out, stats = ss.stratum_sweep(torch.zeros((3, 0), dtype=torch.int32), none,
                                  torch.zeros(5, dtype=torch.int32), none, ks,
                                  carry, 9)
    assert (out == 9).all() and (carry == 9).all()
    assert stats.tolist() == [[4, 1]]


@pytest.mark.parametrize("bad", ["tuv_float", "tuv_1d", "tuv_strided",
                                 "carry_int64", "carry_n", "carry_strided",
                                 "out_shape", "out_dtype", "ks_len", "ks_zero",
                                 "ks_float", "vptr_len", "vptr_end",
                                 "dst_len", "inf"])
def test_stratum_sweep_rejects_what_the_kernel_does_not_take(bad):
    tuv, seg, vptr, dst, inf = map(
        lambda a: torch.as_tensor(a) if isinstance(a, np.ndarray) else a,
        sweep_inputs(5, R=4))
    n = vptr.shape[0] - 1
    ks = torch.tensor([2, 3], dtype=torch.int32)
    carry = torch.zeros((2, n), dtype=torch.int32)
    kw = {}
    if bad == "tuv_float":
        tuv = tuv.float()
    elif bad == "tuv_1d":
        tuv = tuv[0]
    elif bad == "tuv_strided":
        tuv = torch.cat([tuv, tuv], 1)[:, ::2]
    elif bad == "carry_int64":
        carry = carry.long()
    elif bad == "carry_n":
        carry = torch.zeros((2, n + 1), dtype=torch.int32)
    elif bad == "carry_strided":
        carry = torch.zeros((n, 2), dtype=torch.int32).T
    elif bad == "out_shape":
        kw["out"] = torch.zeros((2, 3, n), dtype=torch.int32)
    elif bad == "out_dtype":
        kw["out"] = torch.zeros((2, 4, n), dtype=torch.int64)
    elif bad == "ks_len":
        ks = ks[:1]
    elif bad == "ks_zero":
        ks = torch.tensor([0, 3], dtype=torch.int32)
    elif bad == "ks_float":
        ks = ks.float()
    elif bad == "vptr_len":
        vptr = vptr[:-1]
    elif bad == "vptr_end":
        vptr = vptr.clone()
        vptr[-1] -= 1
    elif bad == "dst_len":
        dst = dst[:-1]
    else:
        inf = 0
    with pytest.raises((TypeError, ValueError)):
        ss.stratum_sweep(tuv, seg, vptr, dst, ks, carry, inf, **kw)


def test_sweep_route_and_bound():
    # two int32 buffers of c in a block's 232,448 bytes of shared memory
    assert ss.sweep_route(1_899) == ss.sweep_route(29_056) == "shared"
    assert ss.sweep_route(29_057) == "global"
    assert ss.SWEEP_ROUTES == ("shared", "global")
    # the CollegeMsg build: t_uv block read once, rows written once, the
    # CSR, ks, carry and counts moved once: ~81 MB, ~24 us at 3.35 TB/s
    K, R, E, n = 37, 193, 34_948, 1_899
    nbytes = (4 * R * E + 4 * K * R * n + 4 * E + 4 * (n + 1) + 4 * K
              + 8 * K * n + 16 * K)
    assert ss.sweep_bound_ms(K, R, E, n) == pytest.approx(
        nbytes / 3.35e12 * 1e3)
    assert 0.023 < ss.sweep_bound_ms(K, R, E, n) < 0.025
