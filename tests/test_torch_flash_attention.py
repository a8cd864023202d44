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


# -- the forward's lse and the backward's routes --------------------------------

@pytest.mark.parametrize("B,S,T,H,Hkv,dh,t_real,causal", [
    (2, 20, 20, 8, 2, 16, 20, True),      # GQA, causal S = T
    (1, 12, 30, 6, 3, 8, 30, True),       # causal S != T (aligned at 0)
    (2, 5, 40, 4, 1, 16, 29, False),      # t_real < T
    (2, 1, 50, 16, 1, 64, 37, False)])    # decode, G = 16
def test_plain_lse_is_the_scores_logsumexp(B, S, T, H, Hkv, dh, t_real,
                                           causal):
    """``return_lse`` gives each row's log-sum-exp of its scaled scores over
    the attended keys: torch.logsumexp of the scores, and jax.nn.logsumexp
    of the same scores formed as the reference model forms them (the kv
    heads expanded with ``take``, scaled in f32), within f32 rounding; the
    output is the one without ``return_lse``, bit for bit."""
    import jax

    (jq, jk, _), (q, k, v) = inputs(B, S, T, H, Hkv, dh, jnp.float32,
                                    torch.float32, seed=S + T + H)
    o, lse = ref.flash_attention(q, k, v, causal=causal, t_real=t_real,
                                 return_lse=True)
    assert torch.equal(o, ref.flash_attention(q, k, v, causal=causal,
                                              t_real=t_real))
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    kh = k[:, :t_real].repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, kh) / dh ** 0.5
    mask = torch.arange(S)[:, None] < torch.arange(t_real)[None, :]
    if causal:
        s = s.masked_fill(mask, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)
    head_map = jnp.arange(H) // (H // Hkv)
    js = jnp.einsum("bshd,bthd->bhst", jq,
                    jnp.take(jk, head_map, axis=2)[:, :t_real])
    js = js.astype(jnp.float32) / np.sqrt(dh)
    if causal:
        js = jnp.where(jnp.asarray(mask.numpy())[None, None], -jnp.inf, js)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.nn.logsumexp(js, axis=-1)), rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version on the CPU, launching nothing
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, t_real=t_real,
                             return_lse=True)
    assert fa.flash_attention.launches == before
    assert torch.equal(got[0], o) and torch.equal(got[1], lse)


@pytest.mark.parametrize("B,S,H,Hkv,t_real,dh,dtype,want", [
    # glm4's train step (1 x 4,096, G = 16): wgmma, the kv heads' 16 query
    # heads in head groups that fill the card
    (1, 4096, 32, 2, 4096, 128, "bf16", ("wgmma", 128)),
    (1, 4000, 32, 2, 4000, 128, "f16", ("wgmma", 128)),
    (1, 4096, 32, 32, 4096, 128, "bf16", ("wgmma", 128)),   # codeqwen, G 1
    (2, 300, 8, 2, 300, 64, "bf16", ("wgmma", 64)),
    (1, 100, 256, 2, 100, 64, "bf16", ("wgmma", 64)),       # G 128
    (1, 100, 12, 4, 100, 128, "bf16", ("mma", 128)),        # G 3
    (2, 8, 4, 2, 40, 128, "bf16", ("mma", 128)),            # 16 rows
    (2, 96, 4, 2, 96, 16, "bf16", ("mma", 16)),             # smoke LMs
    (1, 50, 6, 2, 50, 24, "f16", ("mma", 32)),
    (2, 40, 4, 2, 40, 128, "f32", ("f32", 128)),
    (2, 40, 4, 2, 40, 64, "f64", ("f32", 64)),
    (2, 40, 4, 2, 40, 136, "bf16", ("wide", 136)),
    (3, 1, 8, 2, 300, 256, "f32", ("wide", 256))])
def test_bwd_plan(B, S, H, Hkv, t_real, dh, dtype, want):
    """The backward's route by dtype, head width, G and rows, as the
    forward's ``plan`` picks it; on the wgmma route the head groups divide
    G, hold at most 64 heads each and are the fewest that give
    ``BWD_KV_BLOCKS`` dK/dV blocks (or G of them)."""
    dt = {"f64": torch.float64, **{n: d[1] for n, d in DTYPES.items()}}[dtype]
    p = fa.bwd_plan(B, S, H, Hkv, t_real, True, dh, dt)
    assert (p.route, p.dhp) == want
    G = H // Hkv
    if p.route != "wgmma":
        assert p.groups == 1
        return
    assert fa.plan(B, S, H, Hkv, t_real, True, dh, dt).route == "wgmma"
    assert G % p.groups == 0 and G // p.groups <= fa.BWD_ROW_TILE
    tiles = -(-min(t_real, S) // fa.BWD_KEYS)
    assert p.groups == G or B * Hkv * p.groups * tiles >= fa.BWD_KV_BLOCKS
    assert p.groups == 1 or B * Hkv * (p.groups // 2) * tiles \
        < fa.BWD_KV_BLOCKS


def wgmma_backward(q, k, v, o, do, lse, *, causal, t_real, groups):
    """csrc/flash_attention_bwd.cu's wgmma route on the CPU, in f32 but
    for its roundings: D = rowsum(do * o); P from the forward's lse; dQ per
    128-row tile of (position, head) pairs over 64-key tiles; dK and dV per
    (64 keys of a consumer warpgroup, kv head, head group) over 64-row
    tiles of the group's (position, head) pairs, from the keys' diagonal on
    (the kernel's 128-key block starts at its lower half's diagonal: the
    upper half's extra tiles add exact zeros); P and dS rounded
    to the inputs' dtype before their products; the groups' f32 partials
    summed in group order, then rounded."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    Gg, dt = G // groups, q.dtype
    scale = 1.0 / dh ** 0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    kf[:, t_real:] = 0.0                     # the maps stop at t_real
    vf[:, t_real:] = 0.0
    dsum = (dof * of).sum(-1)                # (B, S, H)
    lse_r = lse.permute(0, 2, 1)             # (B, S, H)
    dq = torch.zeros(B, S, H, dh)
    dk = torch.zeros(B, T, Hkv, dh)
    dv = torch.zeros(B, T, Hkv, dh)

    def masked_p(s, kpos, qpos, lse_rows):
        p = torch.exp(s * scale - lse_rows)
        keep = kpos < t_real
        if causal:
            keep = keep & (kpos <= qpos)
        return torch.where(keep, p, 0.0)

    for b in range(B):
        for hk in range(Hkv):
            # dQ: the forward's rows, 128 a tile, over 64-key tiles
            hs = slice(hk * G, (hk + 1) * G)
            rows = S * G
            qr = qf[b, :, hs].reshape(rows, dh)
            dr = dof[b, :, hs].reshape(rows, dh)
            lr = lse_r[b, :, hs].reshape(rows)
            Dr = dsum[b, :, hs].reshape(rows)
            dq_rows = torch.zeros(rows, dh)
            for r0 in range(0, rows, 128):
                r1 = min(r0 + 128, rows)
                qpos = torch.arange(r0, r1)[:, None] // G
                limit = min(t_real, (r1 - 1) // G + 1) if causal else t_real
                acc = torch.zeros(r1 - r0, dh)
                for kv0 in range(0, limit, 64):
                    kt, vt = kf[b, kv0:kv0 + 64, hk], vf[b, kv0:kv0 + 64, hk]
                    kpos = torch.arange(kv0, kv0 + kt.shape[0])[None, :]
                    p = masked_p(qr[r0:r1] @ kt.T, kpos, qpos,
                                 lr[r0:r1, None])
                    ds = p * (dr[r0:r1] @ vt.T - Dr[r0:r1, None])
                    acc += ds.to(dt).float() @ kt
                dq_rows[r0:r1] = acc * scale
            dq[b, :, hs] = dq_rows.view(S, G, dh)
            # dK, dV: per head group, partials summed in group order
            parts = []
            for grp in range(groups):
                gs = slice(hk * G + grp * Gg, hk * G + (grp + 1) * Gg)
                rows, P = S * Gg, 64 // Gg
                qr = qf[b, :, gs].reshape(rows, dh)
                dr = dof[b, :, gs].reshape(rows, dh)
                lr = lse_r[b, :, gs].reshape(rows)
                Dr = dsum[b, :, gs].reshape(rows)
                pk, pv = torch.zeros(T, dh), torch.zeros(T, dh)
                for kv0 in range(0, min(T, t_real), 64):
                    kt, vt = kf[b, kv0:kv0 + 64, hk], vf[b, kv0:kv0 + 64, hk]
                    kpos = torch.arange(kv0, kv0 + kt.shape[0])[:, None]
                    first = kv0 if causal else 0
                    for p0 in range((first // P) * P, S, P):
                        r0, r1 = p0 * Gg, min(p0 * Gg + 64, rows)
                        qpos = torch.arange(r0, r1)[None, :] // Gg
                        pt = masked_p(kt @ qr[r0:r1].T, kpos, qpos,
                                      lr[None, r0:r1])
                        dst = pt * (vt @ dr[r0:r1].T - Dr[None, r0:r1])
                        pv[kv0:kv0 + 64] += pt.to(dt).float() @ dr[r0:r1]
                        pk[kv0:kv0 + 64] += dst.to(dt).float() @ qr[r0:r1]
                parts.append((pk * scale, pv))
            dk[b, :, hk] = sum(pk for pk, _ in parts)
            dv[b, :, hk] = sum(pv for _, pv in parts)
    return dq.to(dt), dk.to(dt), dv.to(dt)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("B,S,T,H,Hkv,t_real,causal,dh,groups", [
    (1, 40, 40, 32, 2, 40, True, 64, 4),      # glm4's G = 16 in 4 groups
    (1, 40, 40, 32, 2, 40, True, 64, 16),     # one head a group
    (2, 70, 90, 8, 2, 81, False, 64, 2),      # G = 4, t_real < T
    (1, 150, 150, 2, 2, 150, True, 128, 1),   # G = 1: no partials
    (1, 33, 33, 16, 1, 33, True, 64, 1)])     # G = 16 in one group
def test_wgmma_backward_tiling_within_error_bound(B, S, T, H, Hkv, t_real,
                                                  causal, dh, groups,
                                                  dtype):
    """The wgmma backward's tiles, head-group partials and rounded P and
    dS (emulated) stay within ``bwd_error_bound`` of the plain backward,
    and the keys past t_real get no gradient."""
    _, (q, k, v) = inputs(B, S, T, H, Hkv, dh, DTYPES[dtype][0],
                          DTYPES[dtype][1], seed=S + H + groups)
    do = torch.as_tensor(np.random.default_rng(S).normal(
        size=q.shape).astype(np.float32)).to(q.dtype)
    o, lse = ref.flash_attention(q, k, v, causal=causal, t_real=t_real,
                                 return_lse=True)
    got = wgmma_backward(q, k, v, o, do, lse, causal=causal, t_real=t_real,
                         groups=groups)
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                   t_real=t_real)
    scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=causal,
                                            t_real=t_real)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        bound = fa.bwd_error_bound(w, *scales[name])
        assert bool(((a.float() - w.float()).abs() <= bound).all()), name
    assert not got[1][:, t_real:].any() and not got[2][:, t_real:].any()
