"""B5 (tiled GEMM): the port's plain version and wrapper against the JAX
reference's Pallas kernel (interpret mode) and jnp oracle, at the shapes
and dtypes of tests/test_kernels.py::TestMatmul and with its tolerances
(f32 rtol 1e-4, atol 1e-3; bf16 rtol 2e-2, atol 2e-1). Both sides sum in
f32 in different orders, and the reference's bf16 dot may round its
products' sums differently. The kernel itself runs only on an NVIDIA
card: its tests are in test_torch_cuda.py. Mixed float operands are held
to exact equality with the plain product of the promoted operands."""

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


@pytest.mark.parametrize("M,N,K,dtype,route,splits", [
    (16, 4096, 4096, "bf16", "skinny", 4),        # decode wq: 32 tiles
    (16, 151552, 4096, "bf16", "skinny", 1),      # decode head: 1,184 tiles
    (16, 256, 4096, "bf16", "skinny", 16),        # decode wk: 2 tiles
    (16, 13696, 4096, "bf16", "skinny", 1),       # decode ffn.wi: 107 tiles
    (16, 4096, 13696, "bf16", "skinny", 4),       # decode ffn.wo
    (64, 4096, 4096, "bf16", "skinny", 4),        # 64 token rows
    (4096, 4096, 4096, "bf16", "wgmma", 1),       # prefill wq: 512 tiles
    (4096, 256, 4096, "bf16", "wgmma", 4),        # prefill wk: 32 tiles
    (4096, 13696, 4096, "bf16", "wgmma", 1),      # prefill ffn.wi
    (4096, 4096, 13696, "bf16", "wgmma", 1),      # prefill ffn.wo
    (4096, 151552, 4096, "bf16", "wgmma", 1),     # prefill head
    (65, 4096, 4096, "bf16", "wgmma", 8),         # one row tile past 64
    (33, 65, 17, "bf16", "masked", 1),            # K shorter than a step
    (4096, 4096, 4100, "bf16", "masked", 1),      # odd K: rows of 8,200 B
    (300, 20, 136, "bf16", "masked", 1),          # N not a multiple of 8
    (169984, 128, 602, "f32", "f32", 1),          # GNN layer-1
    (169984, 41, 128, "f32", "f32", 1),           # GNN head
    (3276800, 64, 64, "f32", "f32", 1),           # MIND's emb @ S
    (65536, 64, 65536, "f32", "f32", 1),          # MIND's d user: 1,024 tiles
    (64, 64, 200, "f32", "f32", 1),               # K too short to split
    (64, 64, 3276800, "f32", "f32", 396),         # MIND's S gradient: 1 tile
    (602, 128, 169984, "f32", "f32", 39),         # GNN layer-1 weight grad
    (128, 41, 169984, "f32", "f32", 394),         # GNN head weight grad
    (4096, 60, 2048, "f32", "f32", 6),            # qwen2-moe's f32 router
])
def test_plan_fills_the_card_and_covers_k(M, N, K, dtype, route, splits):
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    p = sm.plan(M, N, K, dt)
    assert (p.route, p.splits) == (route, splits)
    want = sm.ROUTE_TILES[route]
    if route == "skinny" and M > 16:
        want = (64, 128, 64)                        # 64 token rows
    if route == "f32" and N <= 48:
        want = (128, 48, 16)                        # 48 columns
    assert p.tile == want
    bk = p.tile[2]
    assert p.k_split % bk == 0
    assert (p.splits - 1) * p.k_split < K <= p.splits * p.k_split
    if route in ("wgmma", "skinny") and splits > 1:
        bm, bn, _ = p.tile
        tiles = -(-M // bm) * -(-N // bn)
        assert tiles * splits <= sm.SM_COUNT      # one wave of work units
    if route == "f32" and splits > 1:             # below a tile per SM
        bm, bn, _ = p.tile
        tiles = -(-M // bm) * -(-N // bn)
        assert tiles < sm.SM_COUNT and tiles * splits <= sm.F32_FILL
        assert p.k_split >= sm.F32_SPLIT_STEPS * bk


@pytest.mark.parametrize("M,N,K", [(16, 4096, 4096), (4096, 13696, 4096),
                                   (4096, 151552, 4096), (65, 256, 4104),
                                   (1, 8, 8), (64, 136, 24)])
def test_tensor_maps_hold_tma_strides_and_boxes(M, N, K):
    """The TMA layouts the wrapper hands to the library: A as (K, M) in
    boxes of (64, BM), B as (N, K) in boxes of 64 columns x 64 rows, each
    box row one 128-byte swizzle row, each stride a multiple of 16 bytes."""
    p = sm.plan(M, N, K)
    assert p.route in ("wgmma", "skinny")
    a, b = sm.tensor_maps(M, N, K, p.tile)
    assert a == sm.TensorMap((K, M), 2 * K, (64, p.tile[0]))
    assert b == sm.TensorMap((N, K), 2 * N, (64, 64))
    for m in (a, b):
        assert m.row_bytes % 16 == 0 and m.box[0] * 2 == 128
        assert m.box[1] <= 256


@pytest.mark.parametrize("M,N,K", [(4096, 4096, 4100), (16, 4097, 4096),
                                   (33, 65, 17), (128, 20, 136),
                                   (16, 4096, 4094)])
def test_unaligned_shapes_never_take_a_tma_route(M, N, K):
    assert sm.plan(M, N, K).route == "masked"
    with pytest.raises(ValueError):
        sm.tensor_maps(M, N, K, sm.ROUTE_TILES["wgmma"])
    # an aligned shape at a misaligned base goes the same way
    assert sm.plan(4096, 4096, 4096, aligned=False).route == "masked"


def test_bound_is_flops_for_prefill_and_bytes_for_decode():
    M, K, N = 4096, 4096, 13696
    assert sm.bound_ms(M, N, K) == pytest.approx(2 * M * N * K / 989e12 * 1e3)
    M = 16
    nbytes = (M * K + K * N) * 2 + 4 * M * N
    assert sm.bound_ms(M, N, K) == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("a,b,want", [
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.float16, torch.float16, torch.float32),
    (torch.float16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32)])
def test_operand_dtype_promotes_to_a_kernel_type(a, b, want):
    """On the card both operands take their promotion, f16 taken to f32:
    every value stays as it was."""
    assert sm.operand_dtype(a, b) == want


def test_operand_dtype_refuses_f64():
    """f64 is no kernel type: its operands are computed in f32, as the
    reference computes them with x64 off (and as ``ref.matmul`` does);
    a dtype that promotes to no float kernel type still raises."""
    assert sm.operand_dtype(torch.float64, torch.float32) == torch.float32
    assert sm.operand_dtype(torch.float64, torch.bfloat16) == torch.float32
    assert sm.operand_dtype(torch.float64, torch.float64) == torch.float32
    with pytest.raises(TypeError):
        sm.operand_dtype(torch.complex64, torch.float32)


@pytest.mark.parametrize("da,db", [("bf16", "f32"), ("f32", "bf16"),
                                   ("f16", "bf16"), ("f16", "f32")])
def test_mixed_operands_equal_the_promoted_product(da, db):
    """Mixed float operands multiply as the reference's f32-accumulated
    product of the promoted operands (B5 on the card casts both to
    operand_dtype, which changes no value)."""
    dts = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(37, 70)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(70, 19)), dtype=torch.float32)
    a, b = a.to(dts[da]), b.to(dts[db])
    dt = sm.operand_dtype(a.dtype, b.dtype)
    assert torch.equal(a.to(dt).float(), a.float())    # the cast is exact
    assert torch.equal(b.to(dt).float(), b.float())
    got = ops.matmul(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.matmul(a.to(dt), b.to(dt)))
