"""B3a (degree count) and B3b (peel threshold): the port's plain versions
and wrappers against the JAX reference's Pallas kernels (interpret mode)
and jnp oracles, and the peel fixpoint against the host peeling oracle.
The fixpoint kernel (B3 redesigned, ``csrc/kcore_fixpoint.cu``): its
bound, its wrapper's argument checks and the int-weight divergence from
the jnp oracle; the emulation of its rounds is in
test_torch_kcore_fixpoint.py.

Every output is an integer or a boolean, so the tolerance is exact
equality. The kernels themselves run only on an NVIDIA card: their tests
are in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import kcore_peel as jax_kp  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import kcore  # noqa: E402
from repro_torch.kernels import kcore_peel as kp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def edges(n, m, seed, p_alive=0.7):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return src, dst, rng.random(m) < p_alive, rng


# the (n, m) x (edge_block, vert_block) sweep of tests/test_kernels.py
@pytest.mark.parametrize("weights", ["bool", "int"])
@pytest.mark.parametrize("eb,vb", [(256, 128), (1024, 512)])
@pytest.mark.parametrize("n,m", [(17, 40), (300, 900), (1025, 3000)])
def test_degree_count_matches_pallas_kernel(n, m, eb, vb, weights):
    src, dst, alive, rng = edges(n, m, n * m)
    if weights == "int":
        alive = (alive * rng.integers(1, 4, m)).astype(np.int32)
    want = np.asarray(jax_kp.degree_count(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(alive), n,
        edge_block=eb, vert_block=vb))
    assert np.array_equal(want, np.asarray(jax_ref.degree_count(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(alive), n)))
    before = kp.degree_count.launches
    got = ops.degree_count(*map(torch.as_tensor, (src, dst, alive)), n)
    assert kp.degree_count.launches == before          # CPU: no launch
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_degree_count_ignores_out_of_range_endpoints():
    src = torch.tensor([0, -1, 3, 7, 2], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3, 0, 9], dtype=torch.int32)
    alive = torch.tensor([1, 1, 2, 1, 1], dtype=torch.int32)
    assert kp.degree_count(src, dst, alive, 4).tolist() == [2, 1, 2, 4]


@pytest.mark.parametrize("k", [2, 3, 5])
def test_peel_round_matches_pallas_kernel(k):
    src, dst, alive, _ = edges(120, 500, k, p_alive=0.9)
    jargs = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(alive))
    want = np.asarray(jax_kp.peel_round(*jargs, 120, k))
    want_ref, want_changed = jax_ref.kcore_peel_round(*jargs, 120, k)
    assert np.array_equal(want, np.asarray(want_ref))
    args = tuple(map(torch.as_tensor, (src, dst, alive)))
    changed = torch.zeros(1, dtype=torch.int32)
    before = kp.peel_threshold.launches
    got = kp.peel_round(*args, 120, k, changed=changed)
    assert kp.peel_threshold.launches == before
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert int(changed) == int(bool(want_changed))
    new, flag = ops.kcore_peel_round(*args, 120, k)
    assert torch.equal(new, got) and bool(flag) == bool(want_changed)
    plain, plain_flag = ref.kcore_peel_round(*args, 120, k)
    assert torch.equal(plain, got) and bool(plain_flag) == bool(want_changed)


def test_peel_threshold_flag_stays_clear_when_nothing_dies():
    src, dst, _, _ = edges(10, 40, 1)
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    alive = torch.ones(40, dtype=torch.bool)
    deg = kp.degree_count(src, dst, alive, 10)
    changed = torch.zeros(1, dtype=torch.int32)
    out = kp.peel_threshold(src, dst, alive, deg, 0, changed=changed)
    assert bool(out.all()) and int(changed) == 0
    out = kp.peel_threshold(src, dst, alive, deg, int(deg.max()) + 1,
                            changed=changed)
    assert not bool(out.any()) and int(changed) == 1


@pytest.mark.parametrize("k", [2, 3, 4])
def test_kcore_fixpoint_matches_reference_and_host_peeling(k):
    rng = np.random.default_rng(9 + k)
    n, m = 80, 400
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    want = np.asarray(jax_ref.kcore_fixpoint(jnp.asarray(src),
                                             jnp.asarray(dst), n, k))
    assert np.array_equal(want, kcore.kcore_edge_mask(src, dst, n, k))
    ts, td = torch.as_tensor(src), torch.as_tensor(dst)
    for fix in (ops.kcore_fixpoint, ref.kcore_fixpoint):
        got = fix(ts, td, n, k)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    # a start mask: only its edges may survive
    alive0 = torch.as_tensor(rng.random(src.shape[0]) < 0.8)
    got = ops.kcore_fixpoint(ts, td, n, k, alive0=alive0)
    assert np.array_equal(got.numpy(), kcore.kcore_edge_mask(
        src, dst, n, k, active=alive0.numpy()))


def test_kcore_fixpoint_on_distinct_pairs_is_distinct_kcore():
    # the [peel] phase of chip_smoke.py at a small size
    from repro_torch.core.temporal_graph import bench_graph
    g = bench_graph("fb_like")
    key = np.minimum(g.src, g.dst).astype(np.int64) * g.n + np.maximum(
        g.src, g.dst)
    uniq, inv = np.unique(key, return_inverse=True)
    us = torch.as_tensor((uniq // g.n).astype(np.int32))
    ud = torch.as_tensor((uniq % g.n).astype(np.int32))
    for k in (2, kcore.k_max(g), kcore.k_max(g) + 1):
        got = ops.kcore_fixpoint(us, ud, g.n, k).numpy()[inv]
        assert np.array_equal(got, kcore.distinct_kcore_edge_mask(
            g.src, g.dst, g.n, k)), k


def test_empty_shapes():
    z = torch.zeros(0, dtype=torch.int32)
    zb = torch.zeros(0, dtype=torch.bool)
    assert torch.equal(kp.degree_count(z, z, zb, 3),
                       torch.zeros(3, dtype=torch.int32))
    assert ops.kcore_fixpoint(z, z, 3, 2).shape == (0,)
    one = torch.zeros(1, dtype=torch.int32)
    assert kp.degree_count(one, one, torch.ones(1, dtype=torch.bool),
                           0).shape == (0,)


def test_wrappers_reject_what_the_kernels_do_not_take():
    src, dst, alive, _ = edges(10, 30, 3)
    src, dst, alive = map(torch.as_tensor, (src, dst, alive))
    changed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="integer"):
        kp.degree_count(src.float(), dst, alive, 10)
    with pytest.raises(ValueError, match="length"):
        kp.degree_count(src, dst[:-1], alive, 10)
    with pytest.raises(ValueError, match="alive"):
        kp.degree_count(src, dst, alive[:-1], 10)
    with pytest.raises(ValueError, match="contiguous"):
        kp.degree_count(src[::2], dst[::2], alive[::2], 10)
    deg = kp.degree_count(src, dst, alive, 10)
    with pytest.raises(ValueError, match="changed must be an int32"):
        kp.peel_threshold(src, dst, alive, deg, 2, changed=changed.long())


def test_bounds_count_each_operand_once():
    # B3a: src + dst + alive per edge, deg per vertex; B3b: also the mask
    assert kp.degree_bound_ms(59_835, 1_899) == pytest.approx(
        (9 * 59_835 + 4 * 1_899) / 3.35e12 * 1e3)
    assert kp.threshold_bound_ms(59_835, 1_899, 4) == pytest.approx(
        (13 * 59_835 + 4 * 1_899) / 3.35e12 * 1e3)


def test_fixpoint_bound_counts_each_operand_once():
    # src + dst (8 B) per edge, alive0 (0, 1 or 4 B) per edge, the one-byte
    # mask per edge and the 4-byte round count; the degrees are scratch
    assert kp.fixpoint_bound_ms(17_474) == pytest.approx(
        (9 * 17_474 + 4) / 3.35e12 * 1e3)
    assert kp.fixpoint_bound_ms(1_000, 1) == pytest.approx(
        (10 * 1_000 + 4) / 3.35e12 * 1e3)
    assert kp.fixpoint_bound_ms(461_605, 4) == pytest.approx(
        (13 * 461_605 + 4) / 3.35e12 * 1e3)


def test_int_weight_fixpoint_follows_the_pallas_kernel_not_the_jnp_oracle():
    """An int32 alive0 with weights >= 2 (ROADMAP.md §C, a caveat about the
    reference): the Pallas peel_round (interpret mode) iterated to a
    fixpoint keeps every edge, and so does the port; the jnp oracle ands
    the weight bitwise (2 & 1 == 0) and kills the weight-2 edge."""
    src = np.array([0, 1, 2, 0], np.int32)
    dst = np.array([1, 2, 0, 1], np.int32)
    w = np.array([2, 1, 1, 3], np.int32)
    n, k = 3, 2
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    alive, pallas_rounds = jnp.asarray(w), 0
    while True:
        new = jax_kp.peel_round(js, jd, alive, n, k)
        pallas_rounds += 1
        if np.array_equal(np.asarray(new), np.asarray(alive) > 0):
            break
        alive = new
    pallas = np.asarray(new)
    assert pallas.dtype == bool and pallas.tolist() == [True] * 4
    rounds = torch.zeros(1, dtype=torch.int32)
    port = kp.kcore_fixpoint(torch.as_tensor(src), torch.as_tensor(dst), n,
                             k, torch.as_tensor(w), rounds=rounds)
    assert np.array_equal(port.numpy(), pallas)
    assert int(rounds) == pallas_rounds
    oracle = np.asarray(jax_ref.kcore_fixpoint(js, jd, n, k,
                                               jnp.asarray(w)))
    assert oracle.dtype == np.int32 and oracle.tolist() == [0, 1, 1, 1]
    assert not np.array_equal(oracle > 0, pallas)


def test_fixpoint_wrapper_rejects_what_the_kernel_does_not_take():
    src, dst, alive, _ = edges(10, 30, 4)
    src, dst, alive = map(torch.as_tensor, (src, dst, alive))
    before = kp.kcore_fixpoint.launches
    with pytest.raises(ValueError, match="rounds must be an int32"):
        kp.kcore_fixpoint(src, dst, 10, 2, rounds=torch.zeros(1))
    with pytest.raises(ValueError, match="0 <= n < 2"):
        kp.kcore_fixpoint(src, dst, -1, 2)
    with pytest.raises(TypeError, match="integer"):
        kp.kcore_fixpoint(src.float(), dst, 10, 2)
    with pytest.raises(ValueError, match="alive"):
        kp.kcore_fixpoint(src, dst, 10, 2, alive[:-1])
    # the CPU path takes the plain version and launches nothing
    assert torch.equal(kp.kcore_fixpoint(src, dst, 10, 2, alive),
                       ref.kcore_fixpoint(src, dst, 10, 2, alive))
    assert kp.kcore_fixpoint.launches == before
