"""B6 (flash attention): the port's plain version and wrapper against the
JAX reference's Pallas kernel (interpret mode), whose semantics the port
follows: the causal mask aligned at position 0 (so S != T is compared
too, which tests/test_kernels.py skips against ``ref.flash_attention``),
f32 softmax and p @ v, keys past ``t_real`` masked. GQA inputs are held
against the kernel on the expanded heads (the reference model's
``take``), ``t_real < T`` against the kernel on ``k[:, :t_real]``.
Tolerances are tests/test_kernels.py's: f32 2e-3, bf16 3e-2 (both sides
round the output to bf16 from f32 sums taken in different orders); f16,
which tests/test_kernels.py does not cover, 5e-3 (the same two f32 sums
rounded to f16, 2^-11 relative, a few units apart). The kernels
themselves run only on an NVIDIA card: see test_torch_cuda.py. Their
arithmetic is emulated here where it differs from the plain version's: the
zero padding of the head width (mma and split routes) and the wgmma
route's tiles with P rounded to bf16."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_fa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2),
          "f16": (jnp.float16, torch.float16, 5e-3)}


def inputs(B, S, T, H, Hkv, dh, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    arrs = [np.asarray(jnp.asarray(rng.normal(size=shape), jdt))
            for shape in ((B, S, H, dh), (B, T, Hkv, dh), (B, T, Hkv, dh))]
    return ([jnp.asarray(a) for a in arrs],
            [torch.as_tensor(a.astype(np.float32)).to(tdt) for a in arrs])


def pallas(q, k, v, *, causal, t_real=None, H=None):
    """The JAX kernel on the expanded kv heads and the first t_real keys."""
    Hkv = k.shape[2]
    head_map = jnp.arange(H) // (H // Hkv)
    k, v = (jnp.take(a, head_map, axis=2)[:, :t_real] for a in (k, v))
    return np.asarray(jax_fa.flash_attention(q, k, v, causal=causal, bq=32,
                                             bk=32), np.float32)


def check(B, S, T, H, Hkv, dh, causal, dtype, t_real=None, seed=0):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = inputs(B, S, T, H, Hkv, dh, jdt, tdt, seed)
    want = pallas(jq, jk, jv, causal=causal, t_real=t_real, H=H)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, t_real=t_real)
    assert fa.flash_attention.launches == before        # CPU: no launch
    assert got.dtype == tdt and got.shape == (B, S, H, dh)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# the (S, T) sweep of tests/test_kernels.py::TestFlashAttention, causal
# S != T included
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,T", [(64, 64), (70, 70), (128, 256), (1, 96),
                                 (40, 24)])
def test_plain_version_matches_pallas_kernel(S, T, causal, dtype):
    check(2, S, T, 3, 3, 32, causal, dtype, seed=S * T + causal)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,S,T", [(4, 2, 48, 48), (8, 1, 1, 70),
                                       (16, 2, 1, 130), (6, 3, 20, 33)])
def test_gqa_matches_pallas_kernel_on_expanded_heads(H, Hkv, S, T, causal,
                                                     dtype):
    check(2, S, T, H, Hkv, 16, causal, dtype, seed=H * S + T)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,T,t_real,causal", [
    (1, 96, 1, False), (1, 96, 37, False), (1, 96, 95, False),
    (4, 64, 9, False), (24, 40, 30, True)])
def test_t_real_matches_pallas_kernel_on_the_first_keys(S, T, t_real, causal,
                                                        dtype):
    check(2, S, T, 8, 2, 32, causal, dtype, t_real=t_real, seed=T + t_real)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dh", [8, 12, 64, 136])
@pytest.mark.parametrize("H,Hkv,S,T,causal", [(4, 2, 40, 40, True),
                                              (6, 3, 1, 70, False),
                                              (2, 2, 24, 33, True)])
def test_head_widths_match_pallas_kernel(H, Hkv, S, T, causal, dh, dtype):
    """The kernels' other head widths (dh 8, the narrowest; 12, which the
    wrapper zero-pads to 16; 64, the wgmma route's other width; 136, the
    wide route's) against the Pallas kernel."""
    check(2, S, T, H, Hkv, dh, causal, dtype, seed=dh + S * T)


def test_keys_past_t_real_are_never_read():
    _, (q, k, v) = inputs(1, 1, 50, 4, 2, 16, jnp.float32, torch.float32, 3)
    want = ops.flash_attention(q, k, v, t_real=20)
    k[:, 20:], v[:, 20:] = float("nan"), float("inf")
    assert torch.equal(ops.flash_attention(q, k, v, t_real=20), want)


def test_plain_version_equals_model_decode_mask():
    """t_real = cache_len + 1 is the reference decode's
    ``arange(T) <= cache_len`` mask over a softmax of all T scores."""
    _, (q, k, v) = inputs(2, 1, 40, 4, 4, 16, jnp.float32, torch.float32, 5)
    cache_len = 17
    s = torch.einsum("bshd,bthd->bhst", q, k) / 4.0
    s = s.masked_fill(torch.arange(40) > cache_len, -1e30)
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
    got = ref.flash_attention(q, k, v, t_real=cache_len + 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["t_real=0", "t_real>T", "heads", "dtype",
                                 "shape"])
def test_wrapper_rejects_what_it_cannot_attend(bad):
    q, k, v = torch.ones(1, 2, 4, 8), torch.ones(1, 5, 2, 8), \
        torch.ones(1, 5, 2, 8)
    kw = {}
    if bad == "t_real=0":
        kw["t_real"] = 0
    elif bad == "t_real>T":
        kw["t_real"] = 6
    elif bad == "heads":
        k = v = torch.ones(1, 5, 3, 8)
    elif bad == "dtype":
        v = v.double()
    else:
        v = torch.ones(1, 4, 2, 8)
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("B,S,H,Hkv,t_real,causal,dh,dtype,want", [
    # glm4 decode at batch 16: 32 blocks of 16 rows; 2 blocks fit an SM,
    # so the key range is split 8 ways into 64 of the 512 64-key tiles
    (16, 1, 32, 2, 32768, False, 128, "bf16", ("split", 128, 1, 8, 64)),
    # glm4 prefill at 1 x 4,096: 512 tiles of 128 rows per kv head, 32
    # 128-key tiles
    (1, 4096, 32, 2, 4096, True, 128, "bf16", ("wgmma", 128, 512, 1, 32)),
    # codeqwen (MHA) decode: one row per (b, head), 16 x 32 blocks
    (16, 1, 32, 32, 32768, False, 128, "bf16", ("split", 128, 1, 1, 512)),
    # a short cache: no split of a single tile
    (2, 1, 8, 2, 40, False, 128, "bf16", ("split", 128, 1, 1, 1)),
    # the smoke LMs' dh = 16 on the mma route, padded to nothing
    (2, 16, 4, 2, 16, True, 16, "bf16", ("mma", 16, 1, 1, 1)),
    # dh = 24 padded to 32; a G of 3 does not divide 128: mma at dh 128
    (1, 50, 6, 2, 50, True, 24, "f16", ("mma", 32, 3, 1, 1)),
    (1, 100, 12, 4, 100, True, 128, "bf16", ("mma", 128, 5, 1, 2)),
    # f32: 16-row tiles, 32-key tiles
    (2, 40, 4, 2, 40, True, 16, "f32", ("f32", 16, 5, 1, 2)),
    # dh above 128, any dtype: the wide route's 16-row, 32-key tiles
    (2, 40, 4, 2, 40, True, 136, "bf16", ("wide", 136, 5, 1, 2)),
    (3, 1, 8, 2, 300, False, 256, "f32", ("wide", 256, 1, 1, 10)),
])
def test_plan(B, S, H, Hkv, t_real, causal, dh, dtype, want):
    p = fa.plan(B, S, H, Hkv, t_real, causal, dh, DTYPES[dtype][1])
    assert tuple(p) == want
    keys = min(t_real, S) if causal else t_real
    n_tiles = -(-keys // fa.ROUTE_TILES[p.route][1])
    assert (p.splits - 1) * p.tiles_per_split < n_tiles <= \
        p.splits * p.tiles_per_split
    assert p.dhp >= dh and (p.route in ("wgmma", "f32", "wide")
                            or p.dhp % 16 == 0)


def padded(x, dhp):
    """x with its head width padded by zeros to dhp."""
    return torch.nn.functional.pad(x, (0, dhp - x.shape[-1]))


@pytest.mark.parametrize("dh", [8, 24, 40, 72])
def test_zero_padding_of_the_head_width_changes_nothing(dh):
    """The mma and split routes pad dh to the width of their kernel
    (plan's dhp) with zeros in shared memory and registers and keep the
    scale 1/sqrt(dh): the scores are those of the unpadded inputs, the
    padded output columns are zero, and the rest is the plain version's
    output."""
    B, S, T, H, Hkv = 2, 9, 21, 4, 2
    _, (q, k, v) = inputs(B, S, T, H, Hkv, dh, jnp.float32, torch.float32,
                          seed=dh)
    dhp = fa.plan(B, S, H, Hkv, T, True, dh, torch.bfloat16).dhp
    assert dhp > dh and dhp in fa.MMA_WIDTHS
    qp, kp, vp = (padded(x, dhp) for x in (q, k, v))
    G = H // Hkv
    s = torch.einsum("bsngd,btnd->bngst", q.view(B, S, Hkv, G, dh), k)
    sp = torch.einsum("bsngd,btnd->bngst", qp.view(B, S, Hkv, G, dhp), kp)
    torch.testing.assert_close(sp, s, rtol=1e-6, atol=1e-6)
    sp = sp / dh ** 0.5
    sp = sp.masked_fill(torch.arange(S)[:, None] < torch.arange(T), -1e30)
    op = torch.einsum("bngst,btnd->bsngd", torch.softmax(sp, -1), vp)
    op = op.reshape(B, S, H, dhp)
    assert not op[..., dh:].any()
    torch.testing.assert_close(op[..., :dh],
                               ref.flash_attention(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", [12, 136, 256])
def test_wide_route_and_padding_arithmetic_change_nothing(dh):
    """The SIMT kernel's arithmetic, emulated: dh zero-padded to a multiple
    of 8 (kernel_width) with the scale kept at 1/sqrt(dh), the scores
    summed over 128-column chunks of q and k, the output written one
    128-column chunk per block: the plain version's output within f32
    rounding."""
    B, S, T, H, Hkv = 2, 9, 21, 4, 2
    _, (q, k, v) = inputs(B, S, T, H, Hkv, dh, jnp.float32, torch.float32,
                          seed=dh)
    dhk = fa.kernel_width(dh)
    assert dhk % fa.HEAD_STEP == 0 and 0 <= dhk - dh < fa.HEAD_STEP
    route = fa.plan(B, S, H, Hkv, T, True, dhk, torch.bfloat16).route
    assert route == ("wide" if dh > fa.WIDEST_HEAD else "mma")
    qp, kp, vp = (padded(x, dhk) for x in (q, k, v))
    G = H // Hkv
    qg = qp.view(B, S, Hkv, G, dhk)
    s = sum(torch.einsum("bsngd,btnd->bngst", qg[..., c:c + 128],
                         kp[..., c:c + 128]) for c in range(0, dhk, 128))
    s = (s / dh ** 0.5).masked_fill(
        torch.arange(S)[:, None] < torch.arange(T), float("-inf"))
    p = torch.softmax(s, -1)
    o = torch.cat([torch.einsum("bngst,btnd->bsngd", p, vp[..., c:c + 128])
                   for c in range(0, dhk, 128)], -1).reshape(B, S, H, dhk)
    assert not o[..., dh:].any()
    torch.testing.assert_close(o[..., :dh],
                               ref.flash_attention(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-5)


def wgmma_route(q, k, v, *, causal, t_real):
    """The wgmma route's arithmetic on the CPU: per (b, kv head), the
    packed (position, head) rows in 128-row q tiles over 128-key k/v tiles
    (as many as the tile's last position needs), the online softmax in
    the log2 domain with the diagonal tile masked, P rounded to q's dtype
    before P V, the row sum over the unrounded P, l floored at 1e-30."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    bq, bk = fa.ROUTE_TILES["wgmma"]
    p = fa.plan(B, S, H, Hkv, t_real, causal, dh, q.dtype)
    assert p.route == "wgmma"
    rows = S * G
    scale_log2 = 1.4426950408889634 / dh ** 0.5
    out = torch.empty(B, S, H, dh)
    for b in range(B):
        for hk in range(Hkv):
            qr = q[b, :, hk * G:(hk + 1) * G].reshape(rows, dh).float()
            for tile in range(p.q_tiles):
                r0, r1 = tile * bq, min(tile * bq + bq, rows)
                qpos = torch.arange(r0, r1) // G
                limit = min(t_real, (r1 - 1) // G + 1) if causal else t_real
                m = torch.full((r1 - r0,), float("-inf"))
                l = torch.zeros(r1 - r0)
                acc = torch.zeros(r1 - r0, dh)
                for kv0 in range(0, limit, bk):
                    kp = torch.arange(kv0, kv0 + bk)
                    kt = torch.zeros(bk, dh)      # past t_real: zeros
                    vt = torch.zeros(bk, dh)
                    n = max(0, min(bk, t_real - kv0))
                    kt[:n] = k[b, kv0:kv0 + n, hk].float()
                    vt[:n] = v[b, kv0:kv0 + n, hk].float()
                    s = (qr[r0:r1] @ kt.T) * scale_log2
                    mask = kp[None, :] >= t_real
                    if causal:
                        mask = mask | (kp[None, :] > qpos[:, None])
                    s = s.masked_fill(mask, float("-inf"))
                    m_new = torch.maximum(m, s.amax(1))
                    mu = torch.where(m_new == float("-inf"), 0.0, m_new)
                    alpha = torch.exp2(m - mu)
                    pr = torch.exp2(s - mu[:, None])
                    l = l * alpha + pr.sum(1)
                    acc = acc * alpha[:, None] + pr.to(q.dtype).float() @ vt
                    m = m_new
                o = acc / l.clamp_min(1e-30)[:, None]
                for i, r in enumerate(range(r0, r1)):
                    out[b, r // G, hk * G + r % G] = o[i]
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("B,S,T,H,Hkv,t_real,causal,dh", [
    (1, 40, 300, 32, 2, 300, True, 128),     # G = 16, causal S != T
    (2, 70, 50, 8, 2, 45, True, 64),         # G = 4, S > T, t_real < T
    (1, 150, 200, 2, 2, 200, True, 64),      # G = 1, two q tiles
    (1, 33, 140, 16, 4, 131, False, 128)])   # G = 4, ragged key tile
def test_wgmma_route_arithmetic_within_error_bound(B, S, T, H, Hkv, t_real,
                                                   causal, dh, dtype):
    """The wgmma route's tiles, online softmax and rounded P (emulated)
    stay within the card check's bound of the plain version."""
    _, (q, k, v) = inputs(B, S, T, H, Hkv, dh, DTYPES[dtype][0],
                          DTYPES[dtype][1], seed=S + T + H)
    got = wgmma_route(q, k, v, causal=causal, t_real=t_real)
    want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
    assert bool(((got.float() - want.float()).abs()
                 <= fa.error_bound(want)).all())


def test_library_hashes_the_shared_header(monkeypatch):
    """B6's build counts csrc/sm90.cuh in its hash: an edit of the header
    rebuilds B6 instead of loading a stale library."""
    seen = {}

    def record(name, sources, deps=()):
        seen.update(name=name, sources=list(sources), deps=list(deps))
        raise RuntimeError("recorded")

    monkeypatch.setattr(fa, "build_cuda", record)
    fa._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="recorded"):
            fa.build()
    finally:
        fa._library.cache_clear()
    header = fa._SRC.with_name("sm90.cuh")
    assert header.exists() and header in seen["deps"]
    assert seen["sources"] == [fa._SRC] and seen["name"] == "flash_attention"


def test_bound_counts_the_attended_pairs():
    assert fa.attended_pairs(4, 4, True) == 10
    assert fa.attended_pairs(6, 3, True) == 6 + 3 * 3
    assert fa.attended_pairs(1, 32768, False) == 32768
    # decode: the cache's bytes bound it
    nbytes = 2 * 128 * (2 * 16 * 32 + 2 * 16 * 32768 * 2)
    assert fa.bound_ms(16, 1, 32, 2, 32768, False) == pytest.approx(
        nbytes / 3.35e12 * 1e3)
    # causal prefill: the operations bound it
    flops = 4.0 * 128 * 32 * 4096 * 4097 / 2
    assert fa.bound_ms(1, 4096, 32, 2, 4096, True) == pytest.approx(
        flops / 989e12 * 1e3)


def p_in_bf16(q, k, v, *, causal, t_real):
    """The plain version with P rounded to bf16 before p @ v and the row
    sum taken over the unrounded P, as csrc/flash_attention.cu computes."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    qf = q.float().view(B, S, Hkv, H // Hkv, dh)
    kf, vf = k[:, :t_real].float(), v[:, :t_real].float()
    s = torch.einsum("bsngd,btnd->bngst", qf, kf) / float(dh) ** 0.5
    if causal:
        s = s.masked_fill(torch.arange(S)[:, None]
                          < torch.arange(t_real)[None, :], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bngst,btnd->bsngd", p.bfloat16().float(), vf)
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return (o / l).reshape(B, S, H, dh).to(q.dtype)


@pytest.mark.parametrize("S,T,t_real,causal", [
    (1, 4096, 4096, False), (1, 4096, 1000, False), (256, 256, 256, True)])
def test_error_bound_admits_bf16_p_and_sees_a_missing_key_tile(S, T, t_real,
                                                               causal):
    """The card check's bound on |kernel - plain| holds the kernel's bf16
    P (emulated here) and is broken by the plain version with its last
    key tile left out, at decode over many keys, where the outputs are
    small, and in a causal prefill."""
    _, (q, k, v) = inputs(2, S, T, 16, 1, 128, jnp.bfloat16, torch.bfloat16,
                          seed=T + S)
    want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
    tol = fa.error_bound(want)
    got = p_in_bf16(q, k, v, causal=causal, t_real=t_real)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    cut = ref.flash_attention(q, k, v, causal=causal,
                              t_real=t_real - fa.CHECK_CUT_KEYS)
    assert bool(((cut.float() - want.float()).abs() > tol).any())
