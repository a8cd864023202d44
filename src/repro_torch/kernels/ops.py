"""The port's kernel surface, mirroring ``repro.kernels.ops``.

Every function here dispatches on the device of its tensors: the
hand-written Hopper kernel for CUDA tensors, the plain PyTorch version
(``ref.py``) for CPU tensors. There is no switch that routes CUDA tensors
to the plain version. Every TPU kernel of the reference has its
counterpart here (ROADMAP.md, queue B).

The three kernels the models run, B5 :func:`matmul`, B4
:func:`segment_sum` and B6 :func:`flash_attention`, are
``torch.autograd.Function``s whose backward is a kernel too: B5 twice on
transposed operands (``segment_matmul.matmul_grads``), B4's gather
(``segment_matmul.segment_gather``) and B6's backward
(``flash_attention.flash_attention_bwd``), each on the plain formula of
``ref.py`` for CPU tensors. :func:`gather_rows` is a row gather whose
gradient is B4. Under ``torch.inference_mode`` (serving) they run their
forward alone.
"""

import torch

from . import flash_attention as _fa
from . import segment_matmul as _sm
from .kcore_peel import degree_count, kcore_fixpoint, peel_round
from .label_prop import label_prop_round
from .segmented_select import kth_smallest, segmented_count_le

__all__ = ["degree_count", "flash_attention", "gather_rows", "kcore_fixpoint",
           "kcore_peel_round", "kth_smallest", "label_prop_round", "matmul",
           "segment_sum", "segmented_count_le"]


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _sm.matmul(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        return _sm.matmul_grads(a, b, dc, *ctx.needs_input_grad[:2])


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.vals_dtype = vals.dtype
        return _sm.segment_sum(vals, ids, num_segments)

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return _sm.segment_gather(dout, ids, ctx.vals_dtype), None, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, t_real):
        o = _fa.flash_attention(q, k, v, causal=causal, t_real=t_real)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.t_real = causal, t_real
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv, _ = _fa.flash_attention_bwd(
            q, k, v, o, do, causal=ctx.causal, t_real=ctx.t_real)
        return dq, dk, dv, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        return segment_sum(dy, idx, ctx.n).to(dy.dtype), None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B5: f32[M, N] = a @ b (``segment_matmul.matmul``), differentiable:
    ``da = dc @ b^T`` and ``db = a^T @ dc`` as two more B5 launches, each
    rounded to its operand's dtype."""
    return _MatMul.apply(a, b)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """B4: f32[num_segments, d] sums of ``vals``' rows by ``ids``
    (``segment_matmul.segment_sum``), differentiable in ``vals``: the
    gradient is B4's gather, in ``vals``' dtype."""
    return _SegmentSum.apply(vals, ids, num_segments)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    t_real: int | None = None) -> torch.Tensor:
    """B6 (``flash_attention.flash_attention``), differentiable in q, k and
    v through B6's backward kernels."""
    t_real = k.shape[1] if t_real is None else int(t_real)
    return _FlashAttention.apply(q, k, v, causal, t_real)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (rows of ``x`` by an index vector), whose gradient is B4:
    the rows' gradients summed into ``x``'s rows by ``idx``, in f32 and
    rounded to the gradient's dtype."""
    return _GatherRows.apply(x, idx)


def kcore_peel_round(src, dst, alive, n: int, k: int):
    """One peel round (B3a then B3b): ``(new_alive, changed)``, with
    ``changed`` a 0-dim bool tensor on the edges' device (no host read)."""
    changed = torch.zeros(1, dtype=torch.int32, device=src.device)
    new_alive = peel_round(src, dst, alive, n, k, changed=changed)
    return new_alive, changed[0] != 0
