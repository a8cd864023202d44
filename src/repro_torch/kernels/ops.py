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
(``flash_attention.flash_attention_bwd``). :func:`gather_rows` is a row
gather whose gradient is B4. Under ``torch.inference_mode`` (serving)
they run their forward alone.

B4 and the row gather take an id vector or its :class:`SegmentPlan`
(:func:`segment_plan`: the ids' stable sort, built once per graph); the
Functions keep what they were given for their backward passes, so a plan
built for a forward serves every gradient of it, the second ones too. On
the card B4's sums are bitwise reproducible (a fixed order of adds, no
float atomics), with a plan or without.

:func:`take` is ``jnp.take(table, ids, axis=0)`` with jnp's rules for
ids out of range, on :func:`gather_rows`, so its gradient is B4 too, and
:func:`embedding_bag` is a bag sum over it (``repro.kernels.ops
.embedding_bag``: in the reference an XLA gather and a sum, no Pallas
kernel, so none here either).

B5 and B4 are twice differentiable, on either device: the backward of
:func:`matmul` calls :func:`matmul` itself, that of :func:`segment_sum`
the gather as a Function whose own gradient is :func:`segment_sum`, and
that of :func:`gather_rows` :func:`segment_sum`. A gradient taken with
``create_graph=True`` (NequIP's and MACE's forces) therefore has a graph
of these Functions, and the force loss's gradient runs on the kernels
too. Without ``create_graph`` the backward launches what it launched
before. B6's backward is once differentiable and says so: a second
backward through it raises.
"""

import torch

from . import flash_attention as _fa
from . import segment_matmul as _sm
from .kcore_peel import degree_count, kcore_fixpoint, peel_round
from .label_prop import label_prop_round
from .segmented_select import kth_smallest, segmented_count_le

__all__ = ["SegmentPlan", "degree_count", "embedding_bag", "flash_attention",
           "gather_rows", "kcore_fixpoint", "kcore_peel_round",
           "kth_smallest", "label_prop_round", "matmul", "segment_plan",
           "segment_sum", "segmented_count_le", "take"]

SegmentPlan = _sm.SegmentPlan


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _sm.matmul(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        return _sm.matmul_grads(a, b, dc, *ctx.needs_input_grad[:2],
                                mm=matmul)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, ids, num_segments):
        ctx.ids = ids           # an id vector or its plan
        ctx.vals_dtype = vals.dtype
        return _sm.segment_sum(vals, ids, num_segments)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return (_SegmentGather.apply(dout, ctx.ids, ctx.vals_dtype),
                None, None)


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dout, ids, dtype):
        ctx.ids = ids           # an id vector or its plan
        ctx.S, ctx.dout_dtype = dout.shape[0], dout.dtype
        return _sm.segment_gather(dout, _sm.plan_ids(ids), dtype)

    @staticmethod
    def backward(ctx, dg):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return (segment_sum(dg.contiguous(), ctx.ids,
                            ctx.S).to(ctx.dout_dtype), None, None)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, t_real, keep_lse):
        ctx.causal, ctx.t_real = causal, t_real
        if not keep_lse:
            o = _fa.flash_attention(q, k, v, causal=causal, t_real=t_real)
            ctx.save_for_backward(q, k, v, o)
            return o
        o, lse = _fa.flash_attention(q, k, v, causal=causal, t_real=t_real,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, *lse = ctx.saved_tensors
        dq, dk, dv, _ = _fa.flash_attention_bwd(
            q, k, v, o, do, causal=ctx.causal, t_real=ctx.t_real,
            lse=lse[0] if lse else None)
        return dq, dk, dv, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.ids = idx
        ctx.n = x.shape[0]
        return x[_sm.plan_ids(idx)]

    @staticmethod
    def backward(ctx, dy):
        # dy may be a slice of a wider gradient (a concatenation's)
        return (segment_sum(dy.contiguous(), ctx.ids,
                            ctx.n).to(dy.dtype), None)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B5: f32[M, N] = a @ b (``segment_matmul.matmul``), twice
    differentiable: ``da = dc @ b^T`` and ``db = a^T @ dc`` are two more
    calls of this function (B5 launches on the card), each rounded to its
    operand's dtype."""
    return _MatMul.apply(a, b)


def segment_plan(ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """B4's plan of an id vector and ``num_segments`` segments
    (``segment_matmul.segment_plan``): build it once per graph and pass it
    to :func:`segment_sum` and :func:`gather_rows` wherever they take
    those ids."""
    return _sm.segment_plan(ids, num_segments)


def segment_sum(vals: torch.Tensor, ids, num_segments: int) -> torch.Tensor:
    """B4: f32[num_segments, d] sums of ``vals``' rows by ``ids``, an id
    vector or its :class:`SegmentPlan` (``segment_matmul.segment_sum``),
    twice differentiable in ``vals``: the gradient is B4's gather, in
    ``vals``' dtype, whose gradient is this function again, with the same
    ids or plan."""
    return _SegmentSum.apply(vals, ids, num_segments)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    t_real: int | None = None) -> torch.Tensor:
    """B6 (``flash_attention.flash_attention``), differentiable in q, k and
    v through B6's backward kernels. Where a gradient can flow (grad mode
    on and an input that requires it) the forward also keeps each row's
    log-sum-exp for the backward; otherwise (serving, under
    ``torch.inference_mode``) it writes none."""
    t_real = k.shape[1] if t_real is None else int(t_real)
    keep_lse = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, t_real, keep_lse)


def gather_rows(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` (rows of ``x`` by an index vector, or by the ids of a
    :class:`SegmentPlan` of ``x.shape[0]`` segments), whose gradient is
    B4: the rows' gradients summed into ``x``'s rows by ``idx`` (with its
    plan where one is given), in f32 and rounded to the gradient's
    dtype."""
    if isinstance(idx, SegmentPlan) and idx.num_segments != x.shape[0]:
        raise ValueError(f"the plan has {idx.num_segments} segments, x "
                         f"{x.shape[0]} rows")
    return _GatherRows.apply(x, idx)


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: rows of ``table`` (n, d) by an
    integer id tensor of any shape, giving ``(*ids.shape, d)``, with jnp's
    rules for ids out of range: an id in ``[-n, 0)`` wraps to ``id + n``;
    any other id outside ``[0, n)`` gives a row of NaN and no gradient.
    The rows come from :func:`gather_rows` over the flattened ids, those
    out of range as -1, so the gradient is B4 (which drops -1)."""
    n, d = table.shape
    flat = ids.reshape(-1).to(torch.int32)
    flat = torch.where(flat < 0, flat + n, flat)
    bad = (flat < 0) | (flat >= n)
    rows = gather_rows(table, torch.where(bad, -1, flat))
    return rows.masked_fill_(bad[:, None], float("nan")).view(*ids.shape, d)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """(bags, k) ids -> (bags, d): each bag's rows (:func:`take`, whose
    gradient is B4), times ``weights`` (bags, k) where given, summed over
    the bag (``repro.kernels.ops.embedding_bag``: torch's EmbeddingBag in
    ``"sum"`` mode)."""
    emb = take(table, ids)
    if weights is not None:
        emb = emb * weights[..., None]
    return emb.sum(dim=1)


def kcore_peel_round(src, dst, alive, n: int, k: int):
    """One peel round (B3a then B3b): ``(new_alive, changed)``, with
    ``changed`` a 0-dim bool tensor on the edges' device (no host read)."""
    changed = torch.zeros(1, dtype=torch.int32, device=src.device)
    new_alive = peel_round(src, dst, alive, n, k, changed=changed)
    return new_alive, changed[0] != 0
