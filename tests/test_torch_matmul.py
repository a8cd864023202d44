"""B5 (tiled GEMM): the port's plain version and wrapper against the JAX
reference's Pallas kernel (interpret mode) and jnp oracle, at the shapes
and dtypes of tests/test_kernels.py::TestMatmul and with its tolerances
(f32 rtol 1e-4, atol 1e-3; bf16 rtol 2e-2, atol 2e-1). Both sides sum in
f32 in different orders, and the reference's bf16 dot may round its
products' sums differently. The kernel itself runs only on an NVIDIA
card: its tests are in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import segment_matmul as jax_sm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402

SHAPES = [(64, 64, 64), (200, 300, 150), (128, 256, 384), (33, 65, 17)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def operands(M, K, N, jdt, tdt):
    rng = np.random.default_rng(M + K + N)
    a = np.asarray(jnp.asarray(rng.normal(size=(M, K)), jdt))
    b = np.asarray(jnp.asarray(rng.normal(size=(K, N)), jdt))
    # the same values on both sides: bf16 through float32, exactly
    ta = torch.as_tensor(a.astype(np.float32)).to(tdt)
    tb = torch.as_tensor(b.astype(np.float32)).to(tdt)
    return jnp.asarray(a), jnp.asarray(b), ta, tb


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matmul_matches_pallas_kernel_and_oracle(shape, dtype):
    M, K, N = shape
    jdt, tdt, tol = DTYPES[dtype]
    ja, jb, ta, tb = operands(M, K, N, jdt, tdt)
    before = sm.matmul.launches
    got = ops.matmul(ta, tb)
    assert sm.matmul.launches == before                 # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (M, N)
    for want in (jax_sm.matmul(ja, jb), jax_ref.matmul(ja, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol * 10)
    assert torch.equal(got, ref.matmul(ta, tb))


@pytest.mark.parametrize("bad", ["inner", "rank", "int", "device"])
def test_wrapper_rejects_what_it_cannot_multiply(bad):
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    if bad == "inner":
        b = torch.ones(7, 3)
    elif bad == "rank":
        a = torch.ones(2, 4, 8)
    elif bad == "int":
        a = torch.ones(4, 8, dtype=torch.int32)
    else:
        b = torch.ones(8, 3, device="meta")
    with pytest.raises((ValueError, TypeError)):
        sm.matmul(a, b)


@pytest.mark.parametrize("M,N,K,skinny,splits", [
    (16, 4096, 4096, True, 8),          # decode wq: 32 tiles, split 8
    (16, 151552, 4096, True, 1),        # decode head: 1,184 tiles
    (16, 256, 4096, True, 16),          # decode wk: 2 tiles, 4 steps each
    (4096, 13696, 4096, False, 1),      # prefill ffn.wi
    (4096, 256, 4096, False, 5),        # prefill wk: 64 tiles
    (33, 65, 17, True, 1),              # K shorter than a step
])
def test_plan_fills_the_card_and_covers_k(M, N, K, skinny, splits):
    got_skinny, got_splits, k_split = sm.plan(M, N, K)
    assert (got_skinny, got_splits) == (skinny, splits)
    bk = (sm.SKINNY_TILE if skinny else sm.WIDE_TILE)[2]
    assert k_split % bk == 0
    assert (got_splits - 1) * k_split < K <= got_splits * k_split


def test_bound_is_flops_for_prefill_and_bytes_for_decode():
    M, K, N = 4096, 4096, 13696
    assert sm.bound_ms(M, N, K) == pytest.approx(2 * M * N * K / 989e12 * 1e3)
    M = 16
    nbytes = (M * K + K * N) * 2 + 4 * M * N
    assert sm.bound_ms(M, N, K) == pytest.approx(nbytes / 3.35e12 * 1e3)
