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

On a ``(data, model)`` mesh (a model placed by ``runtime.sharding.
shard_params`` under ``mind_param_specs``, ``configs.init_params(mesh=)``
or :func:`placed`) the steps run the reference's recsys policy by hand
(:class:`Partition`, from :func:`partition_of`): each rank holds its rows
of the table and ``S`` whole, its users of the batch, and looks up
vocab-parallel. The loss keeps the reference's in-batch softmax over the
WHOLE batch, as GSPMD does: the targets are gathered over the data axes
and each rank's logits are its users against all B targets; a softmax
over each rank's own targets would be another loss. On a one-rank mesh
nothing is exchanged and every step is the unsharded one bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..kernels import ops
from ..runtime import sharding as shd


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
                 hist_mask: torch.Tensor, rep=None) -> torch.Tensor:
    """The interests (B, K, d) of looked-up histories ``emb`` (B, H, d):
    masked, through the bilinear map ``S`` (one B5 product over the B * H
    rows; ``rep``, a :meth:`Partition.rep`, takes it on a mesh), then
    :func:`b2i_routing`."""
    B, H, d = emb.shape
    emb = (emb * hist_mask[..., None]).reshape(B * H, d)
    S = model.S if rep is None else rep(model.S)
    return b2i_routing(model.cfg, ops.matmul(emb, S).view(B, H, d),
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
    """``-sum_i log_softmax(logits)_i,offset+i / B`` of f32 logits (R, B),
    the rows of R users against all B targets, keeping only the logits:
    the backward turns them, in place, into the gradient ``(softmax -
    onehot) * g / B``, the one at column ``offset + i`` of row i. Square
    logits of the whole batch (``offset`` None) take the mean, as the
    reference does. Once differentiable."""

    @staticmethod
    def forward(ctx, logits, offset):
        R, B = logits.shape
        rows = max(1, _LSE_ELEMS // max(B, 1))
        lse = torch.cat([torch.logsumexp(logits[r:r + rows], dim=1)
                         for r in range(0, R, rows)])
        ctx.save_for_backward(logits, lse)
        ctx.offset = offset or 0
        terms = lse - logits.diagonal(ctx.offset)
        return terms.mean() if offset is None else terms.sum() / B

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        p = logits.sub_(lse[:, None]).exp_()
        p.diagonal(ctx.offset).sub_(1.0)
        return p.mul_(g / logits.shape[1]), None


def in_batch_softmax_loss(user: torch.Tensor, tgt: torch.Tensor,
                          part: "Partition | None" = None) -> torch.Tensor:
    """The sampled softmax with in-batch negatives: the logits ``user @
    tgt^T`` (B, B) on B5, each user's own target the label. On a mesh
    (``part``) ``user`` and ``tgt`` are this rank's rows of the batch: the
    targets are gathered over the data axes (:meth:`Partition.targets`),
    this rank's rows of the logits (B / data, B) formed, their terms
    summed and the sums added over the data axes (:meth:`Partition.total`):
    every user still meets all B targets, and the loss is the global
    mean on every rank."""
    if part is None or not part.dp:
        return _InBatchSoftmax.apply(ops.matmul(user, tgt.t().contiguous()),
                                     None)
    every = part.targets(tgt)
    return part.total(_InBatchSoftmax.apply(
        ops.matmul(user, every.t().contiguous()), part.offset(user)))


def mind_loss(model: MIND, batch: dict, take_fn=None) -> torch.Tensor:
    """The reference's ``mind_loss``: the users' interests, label-aware
    attention on each target, then :func:`in_batch_softmax_loss`. The
    history and the targets are looked up in one call (``take_fn``,
    default :func:`take`, on a mesh :meth:`Partition.take`) over the ids
    (B, H + 1). On a mesh the batch is this rank's rows of it and ``S``
    enters through :meth:`Partition.rep`."""
    part = partition_of(model)
    hist_ids, hist_mask = batch["hist_ids"], batch["hist_mask"]
    H = hist_ids.shape[1]
    tf = take_fn or part.take
    rows = tf(model.item_embed,
              torch.cat([hist_ids, batch["target_id"][:, None]], dim=1))
    interests = interests_of(model, rows[:, :H], hist_mask, part.rep)
    tgt = rows[:, H]
    user = label_aware_attention(model.cfg, interests, tgt)
    return in_batch_softmax_loss(user, tgt, part)


@torch.inference_mode()
def mind_serve(model: MIND, batch: dict, take_fn=None,
               cand_take_fn=None) -> torch.Tensor:
    """Online scoring (B, C): each candidate's dot with the user's best
    interest (``hist_ids``, ``hist_mask``, ``cand_ids`` (B, C)). On a mesh
    the batch is this rank's rows and so are the scores, (B / data, C)."""
    part = partition_of(model)
    ctf = cand_take_fn or take_fn or part.take
    interests = user_interests(model, batch["hist_ids"], batch["hist_mask"],
                               take_fn or part.take)
    cand = ctf(model.item_embed, batch["cand_ids"])             # (B, C, d)
    return torch.einsum("bkd,bcd->bkc", interests, cand).amax(dim=1)


@torch.inference_mode()
def mind_retrieval(model: MIND, batch: dict, take_fn=None,
                   cand_take_fn=None) -> torch.Tensor:
    """One user against a slab of candidates (C,): ``hist_ids`` (1, H),
    ``hist_mask`` (1, H), ``cand_ids`` (C,); the scores ``cand @
    interests^T`` (C, K) are one B5 product, then the best interest's. On
    a mesh every rank takes the user whole and its slice of the slab,
    (C / data,), and returns that slice's scores."""
    part = partition_of(model)
    ctf = cand_take_fn or take_fn or part.take
    interests = user_interests(model, batch["hist_ids"], batch["hist_mask"],
                               take_fn or part.take_whole)
    cand = ctf(model.item_embed, batch["cand_ids"])             # (C, d)
    return ops.matmul(cand, interests[0].t().contiguous()).amax(dim=1)


# ======================================================================
# the (data, model) partition
# ======================================================================

class Partition:
    """How MIND placed on ``mesh`` runs on this rank (the reference's
    recsys policy, ``runtime.sharding.mind_param_specs`` and
    ``mind_batch_specs``): the item table's rows split over ``model``,
    ``S`` whole, the batch's users split over the data axes and replicated
    over ``model``, every model rank computing the same rows, as GSPMD's
    replication does.

    * :meth:`take` is the vocab-parallel lookup of this rank's ids
      (``runtime.sharding.vp_lookup``: the owned rows gathered, the others
      zeroed, the partial rows summed over ``model``; the shard's gradient
      summed over the data axes, which split the ids); :meth:`take_whole`
      the same for ids every data rank holds whole (retrieval's user);
    * :meth:`rep` marks ``S``, used on this rank's users, so that its
      gradient is the whole batch's (``grad_sum`` over the data axes);
    * :meth:`targets` gathers the targets over the data axes
      (``gather_tiled``: its backward adds every rank's cotangent of this
      rank's targets, in rank order), :meth:`offset` is this rank's first
      row in the batch, :meth:`total` sums a loss over the data axes.

    Axes of one rank are left out: on a one-rank mesh, or none, it is the
    identity path (``ops.take``, nothing exchanged), and the steps are the
    unsharded ones bit for bit."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.dp, self.model, self.rank = (), None, 0
            return
        sizes = shd.axis_sizes(mesh)
        self.dp = tuple(a for a in shd.dp_axes(mesh) if sizes[a] > 1)
        self.model = "model" if sizes["model"] > 1 else None
        self.rank = shd._combined_index(mesh, self.dp)[0]

    def _lookup(self, table, ids, leading):
        if self.model is None:
            return ops.take(shd.grad_sum(table, self.mesh, leading), ids)
        return shd.vp_lookup(table, ids, self.mesh, self.model, leading)

    def take(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return self._lookup(table, ids, self.dp)

    def take_whole(self, table: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
        return self._lookup(table, ids, ())

    def rep(self, w: torch.Tensor) -> torch.Tensor:
        return shd.grad_sum(w, self.mesh, self.dp)

    def targets(self, tgt: torch.Tensor) -> torch.Tensor:
        return shd.gather_tiled(tgt.contiguous(), self.mesh, self.dp)

    def offset(self, rows: torch.Tensor) -> int:
        return self.rank * rows.shape[0]

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return shd.psum(x, self.mesh, self.dp)


#: the partition of no mesh: the whole batch on this device
WHOLE = Partition()


def partition_of(model: MIND) -> Partition:
    """The model's partition: :class:`Partition` of its ``mesh`` (set by
    ``runtime.sharding.shard_params``), :data:`WHOLE` without one."""
    mesh = getattr(model, "mesh", None)
    return WHOLE if mesh is None else Partition(mesh)


def placed(cfg: MINDConfig, shards: dict, mesh) -> MIND:
    """A :class:`MIND` of ``cfg`` on ``mesh`` from this rank's shards
    (``{name: tensor}``, e.g. ``core.carry.mind_params_from_reference(
    tree, mesh)``), each checked against its spec's shard shape."""
    model = MIND(cfg, device="meta")
    specs = shd.mind_param_specs(model)
    for name, p in list(model.named_parameters()):
        want = shd.shard_shape(p.shape, specs[name], mesh)
        if tuple(shards[name].shape) != want:
            raise ValueError(f"{name}: a shard of {tuple(shards[name].shape)}"
                             f", {specs[name]} of {tuple(p.shape)} gives "
                             f"{want}")
        shd.set_param(model, name, shards[name])
    model.mesh = mesh
    return model
