"""B6 (flash attention): the port's plain version and wrapper against the
JAX reference's Pallas kernel (interpret mode), whose semantics the port
follows: the causal mask aligned at position 0 (so S != T is compared
too, which tests/test_kernels.py skips against ``ref.flash_attention``),
f32 softmax and p @ v, keys past ``t_real`` masked. GQA inputs are held
against the kernel on the expanded heads (the reference model's
``take``), ``t_real < T`` against the kernel on ``k[:, :t_real]``.
Tolerances are tests/test_kernels.py's: f32 2e-3, bf16 3e-2 (both sides
round the output to bf16 from f32 sums taken in different orders). The
kernel itself runs only on an NVIDIA card: see test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_fa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


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


@pytest.mark.parametrize("B,S,H,Hkv,t_real,causal,want", [
    # glm4 decode at batch 16: 32 blocks of 16 rows, the key range split 9
    # ways into 57 of the 512 tiles each (the last 56)
    (16, 1, 32, 2, 32768, False, (1, 1, 9, 57)),
    # glm4 prefill at 1 x 4,096: 1,024 tiles of 64 rows per kv head
    (1, 4096, 32, 2, 4096, True, (4, 1024, 1, 64)),
    # codeqwen (MHA) decode: one row per (b, head), 16 x 32 blocks
    (16, 1, 32, 32, 32768, False, (1, 1, 1, 512)),
    # a short cache: no split of a single tile
    (2, 1, 8, 2, 40, False, (1, 1, 1, 1)),
])
def test_plan(B, S, H, Hkv, t_real, causal, want):
    nwq, q_tiles, splits, per = fa.plan(B, S, H, Hkv, t_real, causal)
    assert (nwq, q_tiles, splits, per) == want
    n_tiles = -(-(min(t_real, S) if causal else t_real) // fa.KV_TILE)
    assert (splits - 1) * per < n_tiles <= splits * per


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
                              t_real=t_real - fa.KV_TILE)
    assert bool(((cut.float() - want.float()).abs() > tol).any())
