"""MIND, the Multi-Interest Network with Dynamic routing
[arXiv:1904.08030], on the port's B4 and B5 kernels.

Counterpart of ``repro.models.recsys``: the same config, the parameters
under the reference's names (``item_embed`` (n_items, d), ``S`` (d, d),
both f32; ``core.carry.mind_params_from_reference``) and the same
arithmetic, so the reference's weights give its outputs:

  item table (V, d) -> behaviour embeddings (B, H, d), masked, @ S
  -> B2I dynamic capsule routing (3 iterations) -> K = 4 interests (B, K, d)
  -> label-aware attention and an in-batch sampled softmax (train), the
  best interest's dot with each candidate (serve), or one user against a
  slab of candidates (retrieval).

Where the reference calls ``jnp.take`` and ``x @ w``, the port calls its
kernels:

* every lookup is :func:`take`, ``jnp.take``'s rules for ids out of range
  on ``ops.gather_rows``, whose gradient (the item table's, dense, as the
  reference's scatter-add into zeros) is B4. The loss looks up the
  history and the targets in ONE call over the ids (B, H + 1), each
  user's history then its target, so a train step builds one B4 plan and
  launches B4 once (the same sum as the reference's two lookups, its adds
  in another order);
* every 2-D product is ``ops.matmul`` (B5, its f32 route): the bilinear
  map ``emb @ S``, the in-batch logits ``user @ tgt^T`` and retrieval's
  scores, and, through B5's gradient, their gradients.

The per-user batched contractions (the routing's einsums, label-aware
attention, serving's ``bkd,bcd->bkc``) stay ``torch.einsum``, as
``models/equivariant.py`` keeps its contractions: they lie outside any
Pallas kernel in the reference and are not 2-D products.

The in-batch softmax is one ``autograd.Function``
(:func:`in_batch_softmax_loss`): at 65,536 users every (B, B) f32 tensor
is 16 GiB, and the Function keeps only the logits, forming the
gradient ``(softmax - I) / B`` in their place, where eager autograd
through ``log_softmax`` and a gather would hold three or four such
tensors. Serving and retrieval run under ``torch.inference_mode()``.

A batch is the reference's, as tensors on one device: ``hist_ids`` (B, H)
int32, ``hist_mask`` (B, H) f32 and, to train, ``target_id`` (B,) int32;
to serve, ``cand_ids`` (B, C) int32; for retrieval ``hist_ids`` (1, H) and
``cand_ids`` (C,). ``take_fn`` (the history's and the targets' lookup)
and ``cand_take_fn`` (the candidates', default ``take_fn``) replace
:func:`take` as the reference's hooks do: ``runtime.sharding.make_vp_take``
is the vocab-parallel lookup, the table's rows split over the ``model``
axis.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 8_388_608       # 2**23 rows (spec: 10^6–10^9)
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0             # label-aware attention sharpness


class MIND(nn.Module):
    """MIND's parameters: ``item_embed`` (n_items, embed_dim) and the
    bilinear capsule map ``S`` (embed_dim, embed_dim), f32, and its
    ``cfg``."""

    def __init__(self, cfg: MINDConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.item_embed = nn.Parameter(torch.empty(
            (cfg.n_items, d), dtype=torch.float32, device=device),
            requires_grad=False)
        self.S = nn.Parameter(torch.empty((d, d), dtype=torch.float32,
                                          device=device),
                              requires_grad=False)


@torch.no_grad()
def init_params(cfg: MINDConfig, generator: torch.Generator,
                device="cuda") -> MIND:
    """A :class:`MIND` with the reference's initial distributions
    (``mind_init``): ``item_embed`` N(0, 1) x 0.02, ``S`` N(0, 1) /
    sqrt(embed_dim), drawn in place from ``generator`` (which lives on
    ``device``); the bits are not the reference's."""
    model = MIND(cfg, device)
    model.item_embed.normal_(generator=generator).mul_(0.02)
    model.S.normal_(generator=generator).div_(math.sqrt(cfg.embed_dim))
    return model


#: the lookup: ``jnp.take(table, ids, axis=0)``'s rules on B4's gather
take = ops.take


def squash(x: torch.Tensor, dim: int = -1, eps: float = 1e-9
           ) -> torch.Tensor:
    """The capsule nonlinearity ``|x|^2 / (1 + |x|^2) * x / sqrt(|x|^2 +
    eps)`` over ``dim``."""
    n2 = (x * x).sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + eps)


def routing_init(K: int, H: int, device=None) -> torch.Tensor:
    """The routing logits' fixed init (K, H), f32: ``sin(k * 12.9898 + h *
    78.233) * 0.01``, each operation in f32 as the reference's weakly
    typed jnp arithmetic does it (it stands in for the paper's random
    init)."""
    f32 = dict(dtype=torch.float32, device=device)
    k = torch.arange(K, **f32)[:, None] * torch.tensor(12.9898, **f32)
    h = torch.arange(H, **f32)[None, :] * torch.tensor(78.233, **f32)
    return torch.sin(k + h) * torch.tensor(0.01, **f32)


def b2i_routing(cfg: MINDConfig, behavior: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Behaviour-to-interest dynamic routing: ``behavior`` (B, H, d),
    ``mask`` (B, H) -> the interests (B, K, d), ``cfg.capsule_iters``
    iterations of the reference's ``one_iter``."""
    B, H, _ = behavior.shape
    blog = routing_init(cfg.n_interests, H, behavior.device)[None].expand(
        B, -1, -1)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=1) * mask[:, None, :]   # over interests
        u = squash(torch.einsum("bkh,bhd->bkd", w, behavior))
        blog = blog + torch.einsum("bkd,bhd->bkh", u, behavior)
    return u


def interests_of(model: MIND, emb: torch.Tensor,
                 hist_mask: torch.Tensor) -> torch.Tensor:
    """The interests (B, K, d) of looked-up histories ``emb`` (B, H, d):
    masked, through the bilinear map ``S`` (one B5 product over the B * H
    rows), then :func:`b2i_routing`."""
    B, H, d = emb.shape
    emb = (emb * hist_mask[..., None]).reshape(B * H, d)
    return b2i_routing(model.cfg, ops.matmul(emb, model.S).view(B, H, d),
                       hist_mask)


def user_interests(model: MIND, hist_ids: torch.Tensor,
                   hist_mask: torch.Tensor, take_fn=None) -> torch.Tensor:
    """``hist_ids`` (B, H) int32, ``hist_mask`` (B, H) f32 -> the interests
    (B, K, d): the history's lookup (``take_fn``, default :func:`take`),
    then :func:`interests_of`."""
    tf = take_fn or take
    return interests_of(model, tf(model.item_embed, hist_ids), hist_mask)


def label_aware_attention(cfg: MINDConfig, interests: torch.Tensor,
                          target_emb: torch.Tensor) -> torch.Tensor:
    """The interests (B, K, d) weighted by ``softmax(pow_p * <interest,
    target>)`` over K -> the user vector (B, d)."""
    att = torch.einsum("bkd,bd->bk", interests, target_emb)
    att = torch.softmax(cfg.pow_p * att, dim=-1)
    return torch.einsum("bk,bkd->bd", att, interests)


#: rows of the (B, B) logits a logsumexp takes at a time (its temporaries
#: then stay near 2**26 floats, 256 MiB)
_LSE_ELEMS = 2**26


class _InBatchSoftmax(torch.autograd.Function):
    """``-mean_i log_softmax(logits)_ii`` of square f32 logits, keeping
    only the logits: the backward turns them, in place, into the gradient
    ``(softmax - I) * g / B``. Once differentiable."""

    @staticmethod
    def forward(ctx, logits):
        B = logits.shape[0]
        rows = max(1, _LSE_ELEMS // max(B, 1))
        lse = torch.cat([torch.logsumexp(logits[r:r + rows], dim=1)
                         for r in range(0, B, rows)])
        ctx.save_for_backward(logits, lse)
        return (lse - logits.diagonal()).mean()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        p = logits.sub_(lse[:, None]).exp_()
        p.diagonal().sub_(1.0)
        return p.mul_(g / logits.shape[0])


def in_batch_softmax_loss(user: torch.Tensor,
                          tgt: torch.Tensor) -> torch.Tensor:
    """The sampled softmax with in-batch negatives: the logits ``user @
    tgt^T`` (B, B) on B5, each user's own target the label."""
    return _InBatchSoftmax.apply(ops.matmul(user, tgt.t().contiguous()))


def mind_loss(model: MIND, batch: dict, take_fn=None) -> torch.Tensor:
    """The reference's ``mind_loss``: the users' interests, label-aware
    attention on each target, then :func:`in_batch_softmax_loss`. The
    history and the targets are looked up in one call (``take_fn``,
    default :func:`take`) over the ids (B, H + 1)."""
    hist_ids, hist_mask = batch["hist_ids"], batch["hist_mask"]
    H = hist_ids.shape[1]
    tf = take_fn or take
    rows = tf(model.item_embed,
              torch.cat([hist_ids, batch["target_id"][:, None]], dim=1))
    interests = interests_of(model, rows[:, :H], hist_mask)
    tgt = rows[:, H]
    user = label_aware_attention(model.cfg, interests, tgt)
    return in_batch_softmax_loss(user, tgt)


@torch.inference_mode()
def mind_serve(model: MIND, batch: dict, take_fn=None,
               cand_take_fn=None) -> torch.Tensor:
    """Online scoring (B, C): each candidate's dot with the user's best
    interest (``hist_ids``, ``hist_mask``, ``cand_ids`` (B, C))."""
    ctf = cand_take_fn or take_fn or take
    interests = user_interests(model, batch["hist_ids"], batch["hist_mask"],
                               take_fn)
    cand = ctf(model.item_embed, batch["cand_ids"])             # (B, C, d)
    return torch.einsum("bkd,bcd->bkc", interests, cand).amax(dim=1)


@torch.inference_mode()
def mind_retrieval(model: MIND, batch: dict, take_fn=None,
                   cand_take_fn=None) -> torch.Tensor:
    """One user against a slab of candidates (C,): ``hist_ids`` (1, H),
    ``hist_mask`` (1, H), ``cand_ids`` (C,); the scores ``cand @
    interests^T`` (C, K) are one B5 product, then the best interest's."""
    ctf = cand_take_fn or take_fn or take
    interests = user_interests(model, batch["hist_ids"], batch["hist_mask"],
                               take_fn)
    cand = ctf(model.item_embed, batch["cand_ids"])             # (C, d)
    return ops.matmul(cand, interests[0].t().contiguous()).amax(dim=1)
