"""Decoder-only dense LM: GQA + RoPE, prefill and decode on the port's kernels.

Counterpart of ``repro.models.transformer`` for the dense architectures
(glm4-9b, codeqwen1.5-7b): the same parameters under the same names, the
same arithmetic and dtypes, so the reference's weights carried over by
``core.carry.lm_params_from_reference`` give its logits. Where the
reference writes the projections as ``x @ w`` and the attention inline in
jnp (``gqa_attention``), the port calls its kernels:

* every dense projection (wq, wk, wv, wo, the FFN's wi/wg/wo and the head)
  is ``ops.matmul`` (B5) on the ``(d_in, d_out)`` weight, its f32 result
  rounded to the activation's dtype as the reference's ``x @ w`` is;
* attention is ``ops.flash_attention`` (B6): causal over the prompt at
  prefill, over the KV cache with ``t_real = cache_len + 1`` at decode,
  each query head reading its kv head without the GQA expansion.

Layers are a ``ModuleList`` run in a Python loop (the reference's
``lax.scan``). The serving functions (:func:`forward`,
:func:`decode_step`) run under ``torch.inference_mode()``; training goes
through :func:`train_forward` and :func:`loss_fn`, with autograd and, when
``cfg.remat`` is set (the reference's default), each layer recomputed in
the backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``). Each kernel's gradient is a kernel too (B5 on
transposed operands, B6's backward; ``kernels/ops.py``); the embedding's
gradient is PyTorch's own scatter of the indexing backward. There is no MoE
path yet (ROADMAP A8): a config with ``moe`` set raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint
from torch import nn

from ..kernels import ops

_NO_MOE = ("MoE layers are not ported yet (ROADMAP A8: MoE dispatch, the "
           "train step and the other families come in later slices)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's MoE settings, kept so a config can name them; the
    port has no MoE path yet and refuses a config that sets them."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    groups: int = 1
    pad_experts: int = 0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layer: int
    d_model: int
    n_head: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 128
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    moe: MoEConfig | None = None
    dtype: torch.dtype = torch.bfloat16
    #: recompute each layer in the backward pass instead of keeping its
    #: activations (the reference's jax.checkpoint of the layer body)
    remat: bool = True

    @property
    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head) of the dense model,
        exact; every one is touched per token."""
        if self.moe is not None:
            raise NotImplementedError(f"{self.name}: {_NO_MOE}")
        d, dh = self.d_model, self.d_head
        attn = d * dh * (self.n_head + 2 * self.n_kv) + self.n_head * dh * d
        if self.qkv_bias:
            attn += dh * (self.n_head + 2 * self.n_kv)
        block = attn + 3 * d * self.d_ff + 2 * d
        return self.vocab * d * 2 + self.n_layer * block + d


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    # frozen for serving; the train step turns gradients on
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DenseFFN(nn.Module):
    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
        self.wi = _param((d, f), dt, device)
        self.wg = _param((d, f), dt, device)
        self.wo = _param((f, d), dt, device)

    def forward(self, x):
        return linear(silu(linear(x, self.wg)) * linear(x, self.wi), self.wo)


class Block(nn.Module):
    """One layer's parameters, named as the reference's layer dict."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        d, dh, hq, hk, dt = (cfg.d_model, cfg.d_head, cfg.n_head, cfg.n_kv,
                             cfg.dtype)
        self.ln1 = _param((d,), torch.float32, device)
        self.ln2 = _param((d,), torch.float32, device)
        self.wq = _param((d, hq * dh), dt, device)
        self.wk = _param((d, hk * dh), dt, device)
        self.wv = _param((d, hk * dh), dt, device)
        self.wo = _param((hq * dh, d), dt, device)
        if cfg.qkv_bias:
            self.bq = _param((hq * dh,), dt, device)
            self.bk = _param((hk * dh,), dt, device)
            self.bv = _param((hk * dh,), dt, device)
        self.ffn = DenseFFN(cfg, device)


class Transformer(nn.Module):
    """The dense LM's parameters: ``embed``, ``layers.<i>.*``, ``ln_f``,
    ``head`` (the reference's pytree with its stacked layers split)."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(f"{cfg.name}: {_NO_MOE}")
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.dtype, device)
        self.head = _param((cfg.d_model, cfg.vocab), cfg.dtype, device)
        self.ln_f = _param((cfg.d_model,), torch.float32, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layer))


@torch.no_grad()
def init_params(cfg: LMConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A model with the reference's initial distributions
    (``transformer.py:110-162``): dense weights N(0, 1/d_in) in
    ``cfg.dtype``, the embedding N(0, 0.02^2), RMSNorm gains 1, QKV biases
    0. Drawn from ``generator``, which lives on ``device``; the bits are
    not the reference's."""
    model = Transformer(cfg, device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "ln_f"):
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            p.zero_()
        else:
            scale = 0.02 if name == "embed" else p.shape[0] ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                    .mul_(scale))
    return model


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis through B5, rounded to x's dtype."""
    lead = x.shape[:-1]
    y = ops.matmul(x.reshape(-1, x.shape[-1]), w)
    return y.to(x.dtype).reshape(*lead, w.shape[1])


def silu(x):
    """``x * sigmoid(x)`` as the reference's ``jax.nn.silu`` rounds it: the
    logistic as ``1 / (1 + exp(-x))``, every operation in x's dtype (one
    rounding in f32 would differ from the reference in ~30% of bf16
    elements by one unit in the last place)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def rms_norm(x, gain, eps=1e-5):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * gain).to(x.dtype)


def rope(x, positions, theta):
    """x: (B, S, H, dh); positions: (B, S) or (S,). Angles in f32, the
    rotation in x's dtype, as the reference."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs              # (B, S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def qkv(p: Block, cfg: LMConfig, x, positions):
    """The attention's inputs of one layer: q (B, S, H, dh) and k, v
    (B, S, Hkv, dh) in x's dtype, q and k rotated."""
    B, S, _ = x.shape
    q, k, v = linear(x, p.wq), linear(x, p.wk), linear(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = rope(q.reshape(B, S, cfg.n_head, cfg.d_head), positions,
             cfg.rope_theta)
    k = rope(k.reshape(B, S, cfg.n_kv, cfg.d_head), positions,
             cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.n_kv, cfg.d_head)


def attention_block(p: Block, cfg: LMConfig, x, positions, *, cache=None,
                    cache_len=None):
    """Attention of one layer: (B, S, d) -> (B, S, d) in x's dtype.

    ``cache`` is this layer's ``(k, v)``, each (B, T, Hkv, dh): the new
    token's k/v are written into it IN PLACE at ``cache_len`` (the
    reference returns an updated copy) and attention reads its first
    ``cache_len + 1`` slots, in the cache's dtype; the attention's output
    goes into ``wo`` in that dtype, and the result is rounded to x's."""
    B, S, _ = x.shape
    q, k, v = qkv(p, cfg, x, positions)
    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True)
    else:
        ck, cv = cache
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        # a cache of another dtype: q takes the cache's (the reference's
        # einsum promotes bf16 q over an f32 cache to f32), the cache is
        # never cast
        out = ops.flash_attention(q.to(ck.dtype), ck, cv, causal=False,
                                  t_real=cache_len + 1)
    out = linear(out.reshape(B, S, cfg.n_head * cfg.d_head), p.wo)
    return out.to(x.dtype)


def _layer(p: Block, cfg: LMConfig, x, positions, cache=None,
           cache_len=None):
    x = x + attention_block(p, cfg, rms_norm(x, p.ln1), positions,
                            cache=cache, cache_len=cache_len)
    return x + p.ffn(rms_norm(x, p.ln2))


# ----------------------------------------------------------------------
# full model
# ----------------------------------------------------------------------

@torch.inference_mode()
def forward(model: Transformer, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, vocab) in f32, aux). ``aux`` is the
    reference's MoE auxiliary loss: 0 for a dense model."""
    cfg = model.cfg
    S = tokens.shape[1]
    x = model.embed[tokens]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    for p in model.layers:
        x = _layer(p, cfg, x, positions)
    x = rms_norm(x, model.ln_f)
    return (linear(x, model.head).float(),
            torch.zeros((), dtype=torch.float32, device=x.device))


def train_forward(model: Transformer, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, vocab) in f32, aux), with autograd:
    :func:`forward`'s arithmetic outside ``inference_mode``, each layer
    under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (its
    kernels run again in the backward pass). ``aux`` is 0 for a dense
    model. A token id past the vocabulary takes the last row and passes
    no gradient to it, as the reference's clamped gather and its
    transpose, which drops an out-of-bounds update, do (``TokenStream``
    emits the id ``vocab`` now and then: its f32 CDF ends a little below
    1)."""
    cfg = model.cfg
    S = tokens.shape[1]
    ids = tokens.long()
    x = model.embed[ids.clamp(0, cfg.vocab - 1)]
    inside = ((ids >= 0) & (ids < cfg.vocab))[..., None]
    x = torch.where(inside, x, x.detach())
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    for p in model.layers:
        if cfg.remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, p, cfg, x, positions, use_reentrant=False)
        else:
            x = _layer(p, cfg, x, positions)
    x = rms_norm(x, model.ln_f)
    return (linear(x, model.head).float(),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross entropy plus ``aux_weight * aux`` (the
    reference's ``loss_fn``): per position the log-sum-exp of the f32
    logits minus the label's logit. The label logit is a gather where the
    reference sums a one-hot product: both pick exactly one logit, so the
    values are equal, and the gather needs no (B, S, vocab) one-hot (2.5
    GB in f32 at glm4's vocab and 4,096 tokens). A label outside the
    vocabulary matches no column of the one-hot: its label logit is 0."""
    logits, aux = train_forward(model, tokens)
    logz = torch.logsumexp(logits, dim=-1)
    lab = labels.long()
    vocab = logits.shape[-1]
    picked = logits.gather(-1, lab.clamp(0, vocab - 1)[..., None])[..., 0]
    label_logit = torch.where((lab >= 0) & (lab < vocab), picked, 0.0)
    return (logz - label_logit).mean() + aux_weight * aux


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """Zeroed KV cache ``{"k", "v"}`` in ``dtype`` (default ``cfg.dtype``),
    each (L, B, T, Hkv, dh). A cache of another dtype than the model's is
    attended in the cache's dtype (:func:`attention_block`)."""
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layer, batch, max_len, cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.inference_mode()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: dict,
                cache_len):
    """One decode step. tokens (B, 1); cache (L, B, T, Hkv, dh) x 2;
    ``cache_len`` an int (or 0-dim tensor) in [0, T). Returns
    ``(logits (B, vocab) in f32, cache)``.

    Unlike the reference, which returns an updated copy of the cache, the
    new token's k/v are written into ``cache`` IN PLACE (slot
    ``cache_len`` of every layer), and the same dict is returned."""
    cfg = model.cfg
    B, S = tokens.shape
    T = cache["k"].shape[2]
    cache_len = int(cache_len)
    if S != 1:
        raise ValueError(f"decode_step takes one token per sequence, got {S}")
    if not 0 <= cache_len < T:
        raise ValueError(f"cache_len must lie in [0, {T}), got {cache_len}")
    x = model.embed[tokens]
    positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    for i, p in enumerate(model.layers):
        x = _layer(p, cfg, x, positions,
                   cache=(cache["k"][i], cache["v"][i]), cache_len=cache_len)
    x = rms_norm(x, model.ln_f)
    return linear(x[:, 0], model.head).float(), cache
