"""The fixpoint kernel (B3 redesigned, ``csrc/kcore_fixpoint.cu``): a numpy
emulation of its rounds (two degree buffers, each round's change caught up
a round later in the other) against the plain loop, the B3a/B3b loop and
the JAX jnp oracle, over random multigraphs drawn by hypothesis; and the
distinct pairs the peel runs on.

Every output is an integer or a boolean, so the tolerance is exact
equality. The kernel itself runs only on an NVIDIA card: its tests are in
test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import kcore as jax_kcore  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import kcore  # noqa: E402
from repro_torch.core.temporal_graph import gen_temporal_graph  # noqa: E402
from repro_torch.kernels import kcore_peel as kp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def emulate_fixpoint(src, dst, n, k, alive0):
    """numpy emulation of csrc/kcore_fixpoint.cu's rounds. D[1] starts as
    deg_1, counted from the weights (every edge 1 when alive0 is None),
    D[0] at 0. Round r reads D[r % 2] and adds into D[(r + 1) % 2]: in
    round 1 one for each kept edge (deg_2), later each edge's change of
    rounds r - 1 and r (in round 2 its byte minus its weight, later -1 for
    a byte of 2); the byte becomes 1 when the edge is kept, 2 when it dies
    (0 in round 1), else 0. The kernel adds a unit after round 1 where the
    weights are 0 or 1 and from round 3 on: the emulation asserts that
    every change is 0 or -1 there. Returns (mask, rounds)."""
    m = src.shape[0]
    w = np.ones(m, np.int64) if alive0 is None else alive0.astype(np.int64)
    unit = alive0 is None or alive0.dtype == bool
    ins, ind = (src >= 0) & (src < n), (dst >= 0) & (dst < n)
    sc, dc = np.clip(src, 0, max(n - 1, 0)), np.clip(dst, 0, max(n - 1, 0))

    def at_ends(x):
        out = np.zeros(n, np.int64)
        np.add.at(out, src[ins], x[ins])
        np.add.at(out, dst[ind], x[ind])
        return out

    D, byte, r = [np.zeros(n, np.int64), at_ends(w)], np.zeros(m, np.int64), 0
    while True:
        r += 1
        assert r <= m + 1
        old = w if r == 1 else (byte == 1).astype(np.int64)
        before = (0 if r == 1 else byte - w if r == 2
                  else -(byte == 2).astype(np.int64))
        keep = (old > 0) & ins & ind
        if n:
            keep &= (D[r % 2][sc] >= k) & (D[r % 2][dc] >= k)
        dies = (old > 0) & ~keep
        byte = np.where(keep, 1, np.where(dies & (r > 1), 2, 0))
        delta = keep.astype(np.int64) if r == 1 else before + keep - old
        if r > 1 and (unit or r > 2):
            assert np.isin(delta, (0, -1)).all()
        D[(r + 1) % 2] += at_ends(delta)
        if not dies.any():
            assert np.array_equal(byte, keep)    # bool at the end
            return keep, r


def peel_rounds_loop(src, dst, n, k, alive):
    """The B3a/B3b round loop through the wrappers: (mask, rounds)."""
    rounds = 0
    while True:
        changed = torch.zeros(1, dtype=torch.int32)
        new = kp.peel_round(src, dst, alive, n, k, changed=changed)
        rounds += 1
        if not int(changed):
            return new, rounds
        alive = new


@st.composite
def peel_inputs(draw, kind):
    n = draw(st.integers(0, 9))
    m = draw(st.integers(0, 28))
    lo, hi = (0, n - 1) if draw(st.booleans()) else (-2, n + 1)
    if hi < lo:                          # n = 0: no id lies in range
        lo, hi = -2, 1
    ids = st.lists(st.integers(lo, hi), min_size=m, max_size=m)
    src = np.asarray(draw(ids), np.int32).reshape(m)
    dst = np.asarray(draw(ids), np.int32).reshape(m)
    alive0 = None
    if kind == "bool":
        alive0 = np.asarray(draw(st.lists(st.booleans(), min_size=m,
                                          max_size=m)), bool).reshape(m)
    elif kind == "int32":
        alive0 = np.asarray(draw(st.lists(st.integers(-2, 3), min_size=m,
                                          max_size=m)), np.int32).reshape(m)
    ok = np.concatenate([src[(src >= 0) & (src < n)],
                         dst[(dst >= 0) & (dst < n)]])
    top = int(np.bincount(ok, minlength=1).max()) if ok.size else 0
    k = draw(st.integers(-1, top + 1))
    return src, dst, n, k, alive0


def check_rounds(src, dst, n, k, alive0):
    """The emulated kernel, the plain loop, the kcore_fixpoint wrapper on
    the CPU and the B3a/B3b loop agree on the mask and the rounds; the jnp
    oracle on the mask where alive0 is bool and every id in [0, n)."""
    want, want_rounds = emulate_fixpoint(src, dst, n, k, alive0)
    ts, td = torch.as_tensor(src), torch.as_tensor(dst)
    ta = None if alive0 is None else torch.as_tensor(alive0)
    for fix in (ref.kcore_fixpoint, kp.kcore_fixpoint):
        rounds = torch.zeros(1, dtype=torch.int32)
        got = fix(ts, td, n, k, ta, rounds=rounds)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
        assert int(rounds) == want_rounds
    start = torch.ones(src.shape[0], dtype=torch.bool) if ta is None else ta
    loop, loop_rounds = peel_rounds_loop(ts, td, n, k, start)
    assert np.array_equal(loop.numpy(), want) and loop_rounds == want_rounds
    # the jnp oracle gathers with clamped or wrapped ids, and ands an int
    # alive0 bitwise: it is the oracle only for bool masks over [0, n)
    in_range = bool(((src >= 0) & (src < n) & (dst >= 0) & (dst < n)).all())
    if n and in_range and (alive0 is None or alive0.dtype == bool):
        jax_mask = np.asarray(jax_ref.kcore_fixpoint(
            jnp.asarray(src), jnp.asarray(dst), n, k,
            None if alive0 is None else jnp.asarray(alive0)))
        assert np.array_equal(jax_mask, want)


@pytest.mark.parametrize("kind", ["none", "bool", "int32"])
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_fixpoint_kernel_rounds_emulated_equal_the_plain_loop(kind, data):
    """Self-loops, out-of-range ids, parallel edges, alive0 of each kind
    (None, bool, int32 weights from -2 to 3), k from -1 to the largest
    degree + 1: the kernel's round structure (emulated) gives the plain
    loop's mask and round count."""
    check_rounds(*data.draw(peel_inputs(kind)))


def long_peel_case(name):
    """(src, dst, n, k, alive0) of a case the hypothesis draws seldom
    reach: int32 weights of 2 that are kept (their change is 1 minus the
    weight, not only the dying edges' -1), and long peels, where each
    round's deaths must reach both degree buffers."""
    if name == "kept_int32_weights":
        return (np.array([0, 3, 2, 0, 2], np.int32),
                np.array([0, 3, 3, 0, 1], np.int32), 4, 3,
                np.array([-1, 1, 2, 2, 1], np.int32))
    if name == "two_chains":
        # vertex 0 hangs on a triangle (1, 2, 3) and holds chains of 2 and
        # 3 edges: at k = 2 it loses an edge in rounds 2 and 3, so its
        # edge to the triangle dies in round 4 only if round 2's death
        # reaches the buffer that round 4 reads
        src = np.array([1, 2, 3, 0, 0, 4, 0, 6, 7], np.int32)
        dst = np.array([2, 3, 1, 1, 4, 5, 6, 7, 8], np.int32)
        return src, dst, 9, 2, None
    # a hub over 40 leaves and a path over the leaves: at k = 3 the path
    # peels two leaves a round from its ends
    leaves = np.arange(1, 41, dtype=np.int32)
    src = np.concatenate([np.zeros(40, np.int32), leaves[:-1]])
    dst = np.concatenate([leaves, leaves[1:]])
    alive0 = {"hub_path": None, "hub_path_bool": np.ones(79, bool),
              "hub_path_int32": np.where(np.arange(79) % 7 == 3, 2, 1
                                         ).astype(np.int32)}[name]
    return src, dst, 41, 3, alive0


@pytest.mark.parametrize("name", ["kept_int32_weights", "two_chains",
                                  "hub_path", "hub_path_bool",
                                  "hub_path_int32"])
def test_fixpoint_kernel_rounds_emulated_on_long_peels(name):
    src, dst, n, k, alive0 = long_peel_case(name)
    check_rounds(src, dst, n, k, alive0)
    mask, rounds = emulate_fixpoint(src, dst, n, k, alive0)
    if name == "two_chains":
        assert rounds == 5 and mask.tolist() == [True] * 3 + [False] * 6
    elif name != "kept_int32_weights":
        assert rounds >= 20


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_distinct_pairs_are_the_reference_distinct_kcore_graph(seed):
    """The distinct pairs, sorted (min, max), map every edge back to its
    pair, and peeling them gives the reference's distinct k-core."""
    g = gen_temporal_graph(n=60, m=900, t_max=20, seed=seed)
    us, ud, inv = kcore.distinct_pairs(g.src, g.dst, g.n)
    key = us * g.n + ud
    assert (us <= ud).all() and (np.diff(key) > 0).all()
    assert np.array_equal(us[inv], np.minimum(g.src, g.dst))
    assert np.array_equal(ud[inv], np.maximum(g.src, g.dst))
    for k in range(1, kcore.k_max(g) + 2):
        want = jax_kcore.distinct_kcore_edge_mask(g.src, g.dst, g.n, k)
        got = kp.kcore_fixpoint(torch.as_tensor(us.astype(np.int32)),
                                torch.as_tensor(ud.astype(np.int32)), g.n, k)
        assert np.array_equal(got.numpy()[inv], want), k
        assert np.array_equal(kcore.distinct_kcore_edge_mask(
            g.src, g.dst, g.n, k), want), k
