"""Decoder-only LM, dense and MoE: GQA + RoPE, prefill and decode on the
port's kernels.

Counterpart of ``repro.models.transformer`` for the five LM architectures
(glm4-9b, codeqwen1.5-7b, qwen1.5-110b dense; qwen2-moe-a2.7b, dbrx-132b
MoE): the same parameters under the same names, the same arithmetic and
dtypes, so the reference's weights carried over by
``core.carry.lm_params_from_reference`` give its logits. Where the
reference writes the projections as ``x @ w`` (or ``einsum``) and the
attention inline in jnp (``gqa_attention``), the port calls its kernels:

* every dense projection (wq, wk, wv, wo, the FFN's wi/wg/wo, each
  expert's and shared expert's wi/wg/wo, the MoE router in f32 and the
  head) is ``ops.matmul`` (B5) on the ``(d_in, d_out)`` weight, its f32
  result rounded to the activation's dtype as the reference's ``x @ w``
  is;
* attention is ``ops.flash_attention`` (B6): causal over the prompt at
  prefill, over the KV cache with ``t_real = cache_len + 1`` at decode,
  each query head reading its kv head without the GQA expansion.

The MoE layer (:func:`moe_ffn`) is the reference's sort-based dispatch
with a static capacity: top-k routing (:func:`route`), a stable sort of
the assignments by expert, a capacity-bounded buffer of ``E * C`` rows,
one B5 launch per expert and weight on the expert's contiguous rows, and
a combine that adds each token's contributions in ascending expert order
in the activation's dtype, as the reference's scatter-add does. Neither
the dispatch nor the combine, nor their gradients, use float atomics.

Layers are a ``ModuleList`` run in a Python loop (the reference's
``lax.scan``). The serving functions (:func:`forward`,
:func:`decode_step`) run under ``torch.inference_mode()``; training goes
through :func:`train_forward` and :func:`loss_fn`, with autograd and, when
``cfg.remat`` is set (the reference's default), each layer recomputed in
the backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``). Each kernel's gradient is a kernel too (B5 on
transposed operands, B6's backward; ``kernels/ops.py``); the embedding's
gradient is PyTorch's own scatter of the indexing backward.

Every layer function runs under the model's :class:`Partition`
(:func:`partition_of`). A model placed on a ``(data, model)`` mesh
(``runtime.sharding.shard_params``, :func:`init_params` with ``mesh``)
computes on this rank's shards, the reference's GSPMD step written out
over ``torch.distributed``: FSDP over ``data``, Megatron TP over
``model``, the logits split over the vocabulary and the loss
vocab-parallel; a MoE layer's experts over ``model`` (EP) where they
divide it, TP inside each expert where not, its dispatch buffer's
capacity rows over ``data`` (:func:`moe_ffn`). A model holding whole
tensors runs under :class:`Whole`, the partition of no mesh, which uses
each weight as held and exchanges nothing.

The reference's sharding hooks (:func:`set_activation_sharding`,
:func:`set_moe_sharding`, :func:`set_weight_use_sharding`) pin layouts
for XLA's partitioner at the same call sites. Here each hook, given a
``runtime.sharding.NamedPlacement``, checks the tensor's layout
(:func:`check_layout`): the identity on a mesh of one rank; on more, the
local shard of the layout :class:`Partition` produces at that site, and
``NotImplementedError`` for any other layout or site.
:func:`set_moe_impl` replaces the whole routed-expert path of
:func:`moe_ffn` (``runtime.moe_a2a.make_a2a_moe``: the all-to-all
dispatch over explicit collectives, which runs at any number of ranks on
global tensors; on a model placed on more than one rank it raises).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint
from torch import nn

from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's MoE settings (``repro.models.transformer.MoEConfig``).
    ``groups`` > 1 routes each of that many token groups on its own, with
    a group-local capacity; ``pad_experts`` adds experts that are never
    routed (their router logits are masked)."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts, qwen2-moe style
    capacity_factor: float = 1.25
    groups: int = 1
    pad_experts: int = 0

    @property
    def e_total(self) -> int:
        return self.n_experts + self.pad_experts


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
        """Total parameters (embedding + blocks + head), the reference's
        count: exact for a dense model; for MoE it counts ``n_experts``
        experts and router columns (pad experts left out)."""
        d, dh = self.d_model, self.d_head
        attn = d * dh * (self.n_head + 2 * self.n_kv) + self.n_head * dh * d
        if self.qkv_bias:
            attn += dh * (self.n_head + 2 * self.n_kv)
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            m = self.moe
            ffn = ((m.n_experts + m.n_shared) * 3 * d * m.d_ff_expert
                   + d * m.n_experts)                      # router
        block = attn + ffn + 2 * d
        return self.vocab * d * 2 + self.n_layer * block + d

    @property
    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: the routed top-k and the
        shared experts only)."""
        if self.moe is None:
            return self.param_count
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return self.param_count - self.n_layer * inactive


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

    def forward(self, x, part: "Partition"):
        return part.row_parallel(
            silu(linear(x, _w(self.wg, "ffn.wg", "ffn.wg", part)))
            * linear(x, _w(self.wi, "ffn.wi", "ffn.wi", part)),
            _w(self.wo, "ffn.wo", "ffn.wo", part))


class MoE(nn.Module):
    """One MoE layer's parameters, named as the reference's ``moe`` dict:
    ``router`` (d, E) in f32, the experts' ``wi``, ``wg`` (E, d, f) and
    ``wo`` (E, f, d), and with ``n_shared`` = s > 0 the shared experts'
    ``shared_wi``, ``shared_wg`` (s, d, f) and ``shared_wo`` (s, f, d);
    E is ``e_total``."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        m, d, dt = cfg.moe, cfg.d_model, cfg.dtype
        e, f = m.e_total, m.d_ff_expert
        self.router = _param((d, e), torch.float32, device)
        self.wi = _param((e, d, f), dt, device)
        self.wg = _param((e, d, f), dt, device)
        self.wo = _param((e, f, d), dt, device)
        if m.n_shared:
            s = m.n_shared
            self.shared_wi = _param((s, d, f), dt, device)
            self.shared_wg = _param((s, d, f), dt, device)
            self.shared_wo = _param((s, f, d), dt, device)


class Block(nn.Module):
    """One layer's parameters, named as the reference's layer dict: the
    attention's, then ``ffn`` for a dense model or ``moe``."""

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
        if cfg.moe is None:
            self.ffn = DenseFFN(cfg, device)
        else:
            self.moe = MoE(cfg, device)


class Transformer(nn.Module):
    """The LM's parameters: ``embed``, ``layers.<i>.*``, ``ln_f``,
    ``head`` (the reference's pytree with its stacked layers split)."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.dtype, device)
        self.head = _param((cfg.d_model, cfg.vocab), cfg.dtype, device)
        self.ln_f = _param((cfg.d_model,), torch.float32, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layer))


@torch.no_grad()
def init_params(cfg: LMConfig, generator: torch.Generator,
                device="cuda", mesh=None) -> Transformer:
    """A model with the reference's initial distributions
    (``transformer.py:110-162``): dense weights N(0, 1/d_in) in
    ``cfg.dtype``, the router N(0, 1/d) in f32, the embedding
    N(0, 0.02^2), RMSNorm gains 1, QKV biases 0. The (E, d, f) and
    (s, d, f) expert weights take the reference's scale 1/sqrt(shape[0]),
    i.e. 1/sqrt(E) and 1/sqrt(s). Drawn from ``generator``, which lives on
    ``device``; the bits are not the reference's.

    With ``mesh`` the model is placed (``runtime.sharding.shard_params``
    under ``lm_param_spec_tree``) as it is drawn: each
    leaf drawn whole, in the same order from the same generator, and only
    this rank's shard kept, rounded to the leaf's dtype, so the shards'
    bits are those of the unplaced model's and the peak is one whole leaf
    in f32, never the model."""
    if mesh is None:
        model = Transformer(cfg, device)
    else:
        from ..runtime import sharding as shd
        Partition(cfg, mesh)
        model = Transformer(cfg, device="meta")
        specs = shd.lm_param_spec_tree(model, mesh)
    for name, p in list(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "ln_f", "bq", "bk", "bv"):
            full = torch.full(p.shape, float(leaf.startswith("ln")),
                              dtype=p.dtype, device=device)
        else:
            scale = 0.02 if name == "embed" else p.shape[0] ** -0.5
            full = torch.randn(p.shape, generator=generator, device=device,
                               dtype=torch.float32).mul_(scale)
        if mesh is None:
            p.copy_(full)
        else:
            shd.check_divides(p.shape, specs[name], mesh, name)
            local = shd.local_shard(full, mesh, specs[name])
            shd.set_param(model, name, torch.empty(
                local.shape, dtype=p.dtype, device=device).copy_(local))
        del full
    if mesh is not None:
        model.mesh = mesh
    return model


def abstract_params(cfg: LMConfig) -> Transformer:
    """The model on ``torch.device("meta")``: every parameter's shape and
    dtype, nothing allocated (the reference's ``jax.eval_shape`` of
    ``init_params``)."""
    return Transformer(cfg, device="meta")


# ----------------------------------------------------------------------
# sharding hooks (read at every call)
# ----------------------------------------------------------------------

#: the residual stream's (B, S, d) placement, checked at every block
#: boundary
ACT_SHARDING = None
#: placements of the (E, C, d) dispatch buffer and the (E, C, f) expert
#: intermediate
MOE_SHARDING = None
#: call-site tag ("attn.wq", "moe.wi", ...) -> a weight's placement at use
WEIGHT_USE_SHARDING = None
#: an alternative routed-expert path for :func:`moe_ffn`
MOE_IMPL = None


def set_activation_sharding(sharding):
    global ACT_SHARDING
    ACT_SHARDING = sharding


def set_moe_sharding(sharding_pair):
    global MOE_SHARDING
    MOE_SHARDING = sharding_pair


def set_weight_use_sharding(table):
    global WEIGHT_USE_SHARDING
    WEIGHT_USE_SHARDING = table


def set_moe_impl(fn):
    global MOE_IMPL
    MOE_IMPL = fn


def _norm_spec(spec) -> tuple:
    """A spec's entries as tuples of axis names, trailing ``()`` dropped,
    so that ``P("data", None)`` and ``P(("data",))`` compare equal."""
    out = [() if part is None else (part,) if isinstance(part, str)
           else tuple(part) for part in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def check_layout(x: torch.Tensor, sharding, produced=None) -> torch.Tensor:
    """``x``, after checking it against ``sharding`` (a
    ``runtime.sharding.NamedPlacement``): its spec must fit x's rank. On a
    mesh of one rank that is all. On more, the reference's
    ``with_sharding_constraint`` asks XLA's partitioner to lay x out; the
    port's partitioner (:class:`Partition`, a dense LM placed by
    ``runtime.sharding.shard_params``) lays out what it lays out, and
    ``produced`` is that: ``(spec, global shape, mesh)`` of the tensor at
    this site on the partitioner's mesh. x must then be the local shard of
    that layout, and ``sharding`` must name it. Any other spec, or a site
    the partitioner does not run (``produced`` None: an unplaced model, a
    MoE buffer it does not lay out so), raises ``NotImplementedError``
    naming the spec: nothing is silently replicated."""
    spec = sharding.spec
    if sharding.size > 1:
        if produced is None:
            raise NotImplementedError(
                f"a sharding hook asks for {spec} on a mesh of "
                f"{sharding.size} ranks at a site the port's partitioner "
                "does not run: it partitions the steps of a model placed "
                "by runtime.sharding.shard_params (the LMs' layers, the "
                "GNNs' aggregations, MIND), laying out what it lays out")
        want, global_shape, mesh = produced
        from ..runtime import sharding as shd
        if _norm_spec(spec) != _norm_spec(want) or \
                shd.axis_sizes(sharding.mesh) != shd.axis_sizes(mesh):
            raise NotImplementedError(
                f"the port's partitioner does not produce the layout {spec} "
                f"on {shd.axis_sizes(sharding.mesh)}: at this site it lays "
                f"the tensor out as {want} on {shd.axis_sizes(mesh)}")
        local = shd.shard_shape(global_shape, want, mesh)
        if tuple(x.shape) != local:
            raise ValueError(f"a local tensor of shape {tuple(x.shape)}, the "
                             f"layout {want} of {tuple(global_shape)} gives "
                             f"{local}")
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{x.dim()} dims")
    return x


def _constrain(x, part: "Partition"):
    if ACT_SHARDING is not None and x.dim() == 3:
        return check_layout(x, ACT_SHARDING, part.act_layout(x))
    return x


def _constrain_moe(x, which: int, part=None, shape=None):
    """x, an (E, C, .) expert tensor (``which`` 0: the dispatch buffer or
    the experts' output, 1: their (E, C, f) intermediate), checked against
    the MoE hook; ``part`` and the global ``shape`` give the layout the
    partitioner produces there."""
    if MOE_SHARDING is not None:
        produced = None if part is None else part.moe_layout(which, shape)
        return check_layout(x, MOE_SHARDING[which], produced)
    return x


def _use_w(w, tag: str, part=None):
    if WEIGHT_USE_SHARDING is not None and tag in WEIGHT_USE_SHARDING:
        produced = None if part is None else part.use_layout(tag)
        return check_layout(w, WEIGHT_USE_SHARDING[tag], produced)
    return w


# ----------------------------------------------------------------------
# the partitioner: the dense LM step on this rank's shards
# ----------------------------------------------------------------------

def kv_heads(n_head: int, n_kv: int, model_size: int, m: int
             ) -> tuple[int, int]:
    """``(lo, hi)``: the kv heads rank ``m`` of ``model_size`` attends
    with, its query heads being ``m * n_head / model_size`` on (contiguous
    column blocks of ``wq``). Where the kv heads divide the axis they are
    split like the query heads; where the axis is a multiple of them (glm4's
    2 kv heads on 4 ranks) every rank's query heads share one kv head,
    ``m * n_kv // model_size``. Any other ratio raises."""
    if n_head % model_size:
        raise NotImplementedError(f"{n_head} query heads do not split over "
                                  f"{model_size} ranks of 'model'")
    if n_kv % model_size == 0:
        per = n_kv // model_size
        return m * per, (m + 1) * per
    if model_size % n_kv:
        raise NotImplementedError(f"{n_kv} kv heads neither divide nor are "
                                  f"divided by {model_size} ranks of 'model'")
    lo = m * n_kv // model_size
    return lo, lo + 1


class Partition:
    """How a model placed on ``mesh`` (``runtime.sharding.shard_params``
    under ``lm_param_spec_tree``) runs its layers on this rank's shards:
    the reference's GSPMD step written out.

    * FSDP over the data axes: a weight's d_model side is gathered at use
      (``sharding.gather_at_use``, whose backward reduce-scatters the
      gradient); a leaf replicated over a data axis has its gradient summed
      over it (``grad_sum``).
    * Megatron TP over ``model``: ``wq``/``wk``/``wv``, ``ffn.wi``/``wg``
      column-parallel, ``attn.wo``/``ffn.wo`` row-parallel with their f32
      partial products summed (``psum``); the replicated activation
      entering a column-parallel product takes ``grad_sum`` over ``model``.
      Query heads split over ``model``; kv heads too where they divide it,
      else ``wk``/``wv``/``bk``/``bv`` are gathered over ``model`` as well
      (their gradients reduce-scattered back) and each rank attends with
      the kv head of its query heads (:func:`kv_heads`).
    * The embedding and the head are split over ``model`` along d_model and
      the vocabulary: the lookup's columns are gathered, the logits stay
      split and the loss is vocab-parallel (:func:`loss_fn`).

    * A MoE layer (:func:`moe_ffn`): the experts over ``model`` (EP) where
      ``model`` divides their count, else TP inside each expert (``wi``,
      ``wg`` column-parallel, ``wo`` row-parallel), as
      ``lm_param_spec_tree`` places them; the dispatch buffer's C rows of
      each expert over the data axes (``c_rows``); the router and the
      shared experts as the dense weights.

    Exchanges over an axis of one rank are left out (they would be
    copies): on a one-rank mesh the step makes none and is the unsharded
    one bit for bit."""

    def __init__(self, cfg: LMConfig, mesh):
        from ..runtime import sharding as shd
        self.shd, self.cfg, self.mesh = shd, cfg, mesh
        sizes = shd.axis_sizes(mesh)
        self.size = math.prod(sizes.values())
        self.sizes = sizes
        self.dp = shd.dp_axes(mesh)
        self.D = math.prod(sizes[a] for a in self.dp)
        #: this rank's index over the data axes, the first major: its
        #: rows of the batch are the d_index-th block
        self.d_index = shd._combined_index(mesh, self.dp)[0]
        self.M, self.m = sizes["model"], shd.axis_index(mesh, "model")
        self.kv_lo, kv_hi = kv_heads(cfg.n_head, cfg.n_kv, self.M, self.m)
        self.kv_split = cfg.n_kv % self.M == 0
        self.hq = cfg.n_head // self.M
        #: kv heads this rank computes: its own, or all where replicated
        self.hk = kv_hi - self.kv_lo if self.kv_split else cfg.n_kv
        one = abstract_params(dataclasses.replace(cfg, n_layer=1))
        self.specs = {n.removeprefix("layers.0."): sp for n, sp in
                      shd.lm_param_spec_tree(one, mesh).items()}
        self.shapes = {n.removeprefix("layers.0."): tuple(t.shape)
                       for n, t in one.named_parameters()}
        #: EP: the experts split over ``model`` (the spec tree's choice)
        self.ep = cfg.moe is not None and self.specs["moe.wi"][0] == "model"

    def live(self, axes) -> tuple:
        """The axes of ``axes`` with more than one rank: an exchange over
        one rank is a copy, and the partitioner makes none."""
        return tuple(a for a in self.shd._axes(axes) if self.sizes[a] > 1)

    def at_use(self, w: torch.Tensor, leaf: str,
               gather_model: bool = False) -> torch.Tensor:
        """The leaf's shard as the layer uses it: gathered over the data
        axes it is split on (and over ``model`` with ``gather_model``),
        its gradient summed over the data axes it is replicated on."""
        shd, spec = self.shd, self.specs[leaf]
        split = set()
        for d, part in enumerate(spec):
            for a in reversed(self.live(part)):
                if a in self.dp or (gather_model and a == "model"):
                    w = shd.gather_at_use(w, self.mesh, a, d)
            split.update(shd._axes(part))
        return shd.grad_sum(w, self.mesh,
                            self.live(tuple(a for a in self.dp
                                            if a not in split)))

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: the identity, the gradient summed over ``model``
        (x, the same on every model rank, enters a column-parallel
        product, each of whose shards sees only its columns)."""
        return self.shd.grad_sum(x, self.mesh, self.live("model"))

    def row_parallel(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` of a row-parallel weight: each rank's f32 partial
        product (B5) summed over ``model``, then rounded to x's dtype as
        :func:`linear` rounds."""
        lead = x.shape[:-1]
        y = self.shd.psum(ops.matmul(x.reshape(-1, x.shape[-1]), w),
                          self.mesh, self.live("model"))
        return y.to(x.dtype).reshape(*lead, w.shape[1])

    def gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """x's last dimension gathered over ``model`` (the embedding's
        columns); the backward keeps this rank's columns, since every model
        rank holds the same cotangent."""
        if self.M == 1:
            return x
        return self.shd.all_gather_tiled(x, self.mesh, "model", dim=-1)

    # -- the MoE layer's exchanges and shares ----------------------------
    def gather_dp(self, x: torch.Tensor, dim: int = 0,
                  same_cotangent: bool = False) -> torch.Tensor:
        """x gathered over the data axes along ``dim`` (in the order of
        ``d_index``). Its backward reduce-scatters (``gather_at_use``: the
        data ranks' cotangents differ, each from its own tokens), or with
        ``same_cotangent`` keeps this rank's chunk (``all_gather_tiled``:
        what follows is computed alike on every data rank)."""
        gather = (self.shd.all_gather_tiled if same_cotangent
                  else self.shd.gather_at_use)
        for a in reversed(self.live(self.dp)):
            x = gather(x, self.mesh, a, dim)
        return x

    def gather_ids(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of an integer tensor, in token order (no
        gradient)."""
        return self.shd.gather_over(x, self.mesh, self.live(self.dp))

    def expert_range(self, E: int) -> tuple[int, int]:
        """``(lo, hi)``: the experts this rank computes (EP: its block of
        E / model; expert TP: all, each on its f / model columns)."""
        if not self.ep:
            return 0, E
        per = E // self.M
        return self.m * per, (self.m + 1) * per

    def c_rows(self, C: int) -> tuple[int, int]:
        """``(lo, hi)``: the rows of each expert's capacity C this rank
        computes, C split over the data axes (the reference rounds C to a
        multiple of 32 so that it splits)."""
        if C % self.D:
            raise NotImplementedError(f"a capacity of {C} rows does not "
                                      f"split over {self.D} data ranks")
        per = C // self.D
        return self.d_index * per, (self.d_index + 1) * per

    # -- the layouts the hooks check against --------------------------
    def act_layout(self, x):
        return (self.shd.P(self.dp, None, None),
                (x.shape[0] * self.D, *x.shape[1:-1], self.cfg.d_model),
                self.mesh)

    def moe_layout(self, which: int, shape):
        """The (E, C, .) expert tensors: EP splits the experts over
        ``model``, expert TP the intermediate's f (``which`` 1); C over the
        data axes."""
        P = self.shd.P
        if self.ep:
            spec = P("model", self.dp, None)
        else:
            spec = P(None, self.dp, "model" if which == 1 else None)
        return spec, tuple(shape), self.mesh

    def use_layout(self, tag: str):
        leaf = tag.removeprefix("attn.")
        P = self.shd.P
        if leaf in ("wo", "ffn.wo"):
            spec = P("model", None)
        elif leaf in ("wk", "wv") and not self.kv_split:
            spec = P(None, None)
        elif leaf in ("wq", "wk", "wv", "ffn.wi", "ffn.wg"):
            spec = P(None, "model")
        elif leaf in ("moe.wi", "moe.wg", "moe.wo") and self.ep:
            spec = P("model", None, None)
        elif leaf in ("moe.wi", "moe.wg", "moe.shared_wi", "moe.shared_wg"):
            spec = P(None, None, "model")
        elif leaf in ("moe.wo", "moe.shared_wo"):
            spec = P(None, "model", None)
        else:
            return None
        return spec, self.shapes[leaf], self.mesh


class Whole(Partition):
    """The partition of a model holding whole tensors: no mesh, every axis
    of one rank, no process group. Each weight is used as it is held, no
    exchange is made and the query and kv heads are all this model's, so
    the layer functions' one body is the unsharded model; no site has a
    partitioned layout for the hooks to check against
    (:func:`check_layout`)."""

    def __init__(self, cfg: LMConfig | None):
        from ..runtime import sharding as shd
        self.shd, self.cfg, self.mesh = shd, cfg, None
        self.sizes, self.size, self.dp, self.D = {}, 1, (), 1
        self.M = 1
        self.m = self.kv_lo = self.d_index = 0
        self.kv_split = self.ep = True
        self.hq, self.hk = (None, None) if cfg is None else (cfg.n_head,
                                                             cfg.n_kv)

    def live(self, axes) -> tuple:
        return ()

    def at_use(self, w, leaf, gather_model=False):
        return w

    def act_layout(self, x):
        return None

    def moe_layout(self, which, shape):
        return None

    def use_layout(self, tag):
        return None


#: the partition of a MoE layer's functions called on whole tensors alone
#: (:func:`_moe_group`, :func:`shared_experts`)
WHOLE = Whole(None)


def partition_of(model: "Transformer") -> Partition:
    """The model's :class:`Partition`, made once: a placed model's (one
    with a ``mesh``, set by ``runtime.sharding.shard_params``), or
    :class:`Whole` for a model holding whole tensors."""
    mesh = getattr(model, "mesh", None)
    part = model.__dict__.get("_partition")
    if part is None or part.mesh is not mesh or part.cfg is not model.cfg:
        part = Whole(model.cfg) if mesh is None else Partition(model.cfg,
                                                               mesh)
        model.__dict__["_partition"] = part
    return part


def placed(cfg: LMConfig, shards: dict, mesh) -> "Transformer":
    """A model of ``cfg`` on ``mesh`` from this rank's shards (``{name:
    tensor}``, e.g. ``core.carry.lm_params_from_reference(tree, mesh)``),
    each checked against its spec's shard shape."""
    from ..runtime import sharding as shd
    Partition(cfg, mesh)
    model = Transformer(cfg, device="meta")
    specs = shd.lm_param_spec_tree(model, mesh)
    for name, p in list(model.named_parameters()):
        want = shd.shard_shape(p.shape, specs[name], mesh)
        if tuple(shards[name].shape) != want:
            raise ValueError(f"{name}: a shard of {tuple(shards[name].shape)}"
                             f", {specs[name]} of {tuple(p.shape)} gives "
                             f"{want}")
        shd.set_param(model, name, shards[name])
    model.mesh = mesh
    return model


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis through B5, rounded to x's dtype."""
    lead = x.shape[:-1]
    y = ops.matmul(x.reshape(-1, x.shape[-1]), w)
    return y.to(x.dtype).reshape(*lead, w.shape[1])


class _SiLU(torch.autograd.Function):
    """:func:`silu` with the reference's gradient, ``g * s + (g * x) *
    (s * (1 - s))`` from the logistic ``s`` (jax's rule for ``logistic``).
    Autograd of ``1 / (1 + exp(-x))`` would multiply 0 by the overflowed
    ``exp(-x)`` where x < -88 and give NaN; pre-activations that low are
    common under the reference's 1/sqrt(E) init of the (E, d, f) expert
    weights (qwen2-moe's shared experts: a standard deviation near 23)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x):
    """``x * sigmoid(x)`` as the reference's ``jax.nn.silu`` rounds it: the
    logistic as ``1 / (1 + exp(-x))``, every operation in x's dtype (one
    rounding in f32 would differ from the reference in ~30% of bf16
    elements by one unit in the last place). Its backward is
    :class:`_SiLU`'s, which stays finite where ``exp(-x)`` overflows."""
    return _SiLU.apply(x)


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


def _w(w, leaf: str, tag: str, part: Partition, gather_model: bool = False):
    """A weight at its use: the partition's gathered shard (the weight
    itself under :class:`Whole`), checked against the hook's layout."""
    return _use_w(part.at_use(w, leaf, gather_model), tag, part)


def qkv(p: Block, cfg: LMConfig, x, positions, part: Partition):
    """The attention's inputs of one layer: q (B, S, H, dh) and k, v
    (B, S, Hkv, dh) in x's dtype, q and k rotated. H is the partition's
    query heads and Hkv its kv heads, or all of them where they are
    replicated over ``model``."""
    B, S, _ = x.shape
    kv_model = not part.kv_split
    q = linear(x, _w(p.wq, "wq", "attn.wq", part))
    k = linear(x, _w(p.wk, "wk", "attn.wk", part, kv_model))
    v = linear(x, _w(p.wv, "wv", "attn.wv", part, kv_model))
    if cfg.qkv_bias:
        q = q + part.at_use(p.bq, "bq")
        k = k + part.at_use(p.bk, "bk", kv_model)
        v = v + part.at_use(p.bv, "bv", kv_model)
    q = rope(q.reshape(B, S, part.hq, cfg.d_head), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, part.hk, cfg.d_head), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, part.hk, cfg.d_head)


def _attend_one_kv(q, ck, cv, lo: int, t_real: int):
    """Decode attention of this rank's query heads over one kv head
    ``lo`` of a cache holding all of them (kv heads replicated over
    ``model``): the query heads put in that head's group of a query
    tensor zero elsewhere, so B6's GQA pairs them with head ``lo``."""
    B, S, hq, dh = q.shape
    qp = q.new_zeros(B, S, ck.shape[2] * hq, dh)
    qp[:, :, lo * hq:(lo + 1) * hq] = q
    out = ops.flash_attention(qp, ck, cv, causal=False, t_real=t_real)
    return out[:, :, lo * hq:(lo + 1) * hq].contiguous()


def attention_block(p: Block, cfg: LMConfig, x, positions, part: Partition,
                    *, cache=None, cache_len=None):
    """Attention of one layer: (B, S, d) -> (B, S, d) in x's dtype.

    ``cache`` is this layer's ``(k, v)``, each (B, T, Hkv, dh): the new
    token's k/v are written into it IN PLACE at ``cache_len`` (the
    reference returns an updated copy) and attention reads its first
    ``cache_len + 1`` slots, in the cache's dtype; the attention's output
    goes into ``wo`` in that dtype, and the result is rounded to x's.
    The heads are the partition's, the cache holds its kv heads (all of
    them where they are replicated: every model rank writes them all) and
    ``wo`` is row-parallel."""
    B, S, _ = x.shape
    q, k, v = qkv(p, cfg, x, positions, part)
    one_kv = not part.kv_split
    if cache is None:
        if one_kv:
            lo = part.kv_lo
            k, v = (t[:, :, lo:lo + 1].contiguous() for t in (k, v))
        out = ops.flash_attention(q, k, v, causal=True)
    else:
        ck, cv = cache
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        # a cache of another dtype: q takes the cache's (the reference's
        # einsum promotes bf16 q over an f32 cache to f32), the cache is
        # never cast
        if one_kv:
            out = _attend_one_kv(q.to(ck.dtype), ck, cv, part.kv_lo,
                                 cache_len + 1)
        else:
            out = ops.flash_attention(q.to(ck.dtype), ck, cv, causal=False,
                                      t_real=cache_len + 1)
    flat = out.reshape(B, S, q.shape[2] * cfg.d_head)
    out = part.row_parallel(flat, _w(p.wo, "wo", "attn.wo", part))
    return out.to(x.dtype)


def capacity(mcfg: MoEConfig, T: int) -> tuple[int, int]:
    """``(G, C)`` of a MoE layer over ``T`` tokens, the reference's: ``G =
    groups`` where it divides T, else 1; per group of ``Tg = T / G`` tokens
    ``C = max(1, min(ceil(Tg * top_k / n_experts * capacity_factor),
    Tg))`` rows per expert, rounded up to a multiple of 32."""
    G = mcfg.groups if T % max(mcfg.groups, 1) == 0 else 1
    Tg = T // G
    C = max(1, min(math.ceil(Tg * mcfg.top_k / mcfg.n_experts
                             * mcfg.capacity_factor), Tg))
    return G, math.ceil(C / 32) * 32


def route(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The experts each token is routed to: the indices of its ``k``
    largest router probabilities, largest first ((T, k) int64; the
    reference's ``jax.lax.top_k``). Equal probabilities keep the lower
    index first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order among ties), so a stable descending sort picks them."""
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def starts_of(se: torch.Tensor, E: int) -> torch.Tensor:
    """Where each expert's run starts in the sorted expert ids ``se``."""
    return torch.searchsorted(se, torch.arange(E, device=se.device),
                              side="left")


def dispatch(eidx: torch.Tensor, E: int, C: int):
    """The reference's sort-based dispatch of (Tg, K) expert ids: the
    assignments (flattened token-major, ``i = t * K + k``) stably sorted by
    expert (``order``), each one's expert ``se`` and token ``st``, its
    position in its expert's run ``pos``, ``keep = pos < C`` and its buffer
    row ``dest`` (``se * C + pos``, or the overflow row ``E * C`` where
    dropped), all in sorted order."""
    Tg, K = eidx.shape
    flat_e = eidx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    st = order // K
    pos = torch.arange(Tg * K, device=se.device) - starts_of(se, E)[se]
    keep = pos < C
    dest = torch.where(keep, se * C + pos, E * C)
    return order, se, st, pos, keep, dest


def router_probs(p: MoE, mcfg: MoEConfig, xt: torch.Tensor,
                 router: torch.Tensor | None = None) -> torch.Tensor:
    """(Tg, E) f32 router probabilities: the logits as one f32 B5 product
    ``xt @ router`` (``p.router`` unless the weight as used is given),
    pad experts' set to -1e30, then a softmax."""
    logits = ops.matmul(xt.float(), p.router if router is None else router)
    if mcfg.pad_experts:
        pad = torch.arange(mcfg.e_total, device=xt.device) >= mcfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    return torch.softmax(logits, dim=-1)


def source_rows(order: torch.Tensor, dest: torch.Tensor, rows: int,
                none: int) -> torch.Tensor:
    """(rows,): for each row of the dispatch buffer, the row of the
    tokens repeated K times (:func:`repeated`) it is gathered from: sorted
    assignment j's ``order[j]`` at ``dest[j]`` where kept, ``none`` (a zero
    row) where no assignment lands. Each repeated row is read at most
    once, so the gather's gradient needs no atomics, and the repeat's is a
    sum over K."""
    src = torch.full((rows + 1,), none, dtype=torch.long, device=order.device)
    src[dest] = order                  # the overflow row is never read
    return src[:rows]


def repeated(xt: torch.Tensor, K: int) -> torch.Tensor:
    """(T * K + 1, d): each token's row K times, then a zero row."""
    T, d = xt.shape
    return torch.cat([xt[:, None].expand(T, K, d).reshape(T * K, d),
                      xt.new_zeros(1, d)])


def token_slots(order: torch.Tensor, dest: torch.Tensor, Tg: int,
                K: int) -> torch.Tensor:
    """(Tg, K): each token's assignments' buffer rows, token-major."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Tg * K, device=order.device)
    return dest[inv].view(Tg, K)


def combine(ho: torch.Tensor, eidx: torch.Tensor, gate: torch.Tensor,
            slot: torch.Tensor) -> torch.Tensor:
    """(T, d): each token's K contributions (gate times its expert's
    output row ``ho[slot]``, in ho's dtype; ``slot`` (T, K) in the order of
    its experts ``eidx``, the zero row where dropped) added one after
    another in ascending expert order, the order in which the reference's
    scatter-add meets them (its assignments sorted by expert)."""
    K = eidx.shape[1]
    by_expert = eidx.argsort(dim=1)
    slot = slot.gather(1, by_expert)
    g = gate.gather(1, by_expert).to(ho.dtype)
    out = ho[slot[:, 0]] * g[:, :1]
    for j in range(1, K):
        out = out + ho[slot[:, j]] * g[:, j:j + 1]
    return out


def _moe_group(p: MoE, mcfg: MoEConfig, xt: torch.Tensor, C: int):
    """One token group (Tg, d) through the routed experts: ``(out (Tg, d)
    in xt's dtype, aux)``, the reference's ``_moe_group``
    (:func:`_routed` with one group on whole tensors)."""
    return _routed(p, mcfg, xt, xt, 1, C, WHOLE)


def _segments(lo: int, n: int, Tg: int) -> list[tuple[int, int, int]]:
    """``(group, a, b)``: the local tokens [a, b) of n whose global
    indices start at ``lo``, cut where a group of Tg tokens ends."""
    out, t = [], lo
    while t < lo + n:
        g = t // Tg
        end = min((g + 1) * Tg, lo + n)
        out.append((g, t - lo, end - lo))
        t = end
    return out


def _routed(p: MoE, mcfg: MoEConfig, xt: torch.Tensor, xr: torch.Tensor,
            G: int, C: int, part: Partition):
    """The routed experts of this rank's tokens xt (Tl, d), the reference's
    ``_moe_group`` over each of G groups of the GLOBAL tokens (the data
    ranks' blocks in order): ``(out (Tl, d) in xt's dtype, aux)``.

    Each rank routes its own tokens: the router (gathered over the data
    axes at use) in f32 on B5, a softmax, :func:`route` (top-k, ties to the
    lower index) and the gates renormalised. The ids of every rank's
    tokens are then gathered, so every rank sorts each group's assignments
    as one device does (:func:`dispatch`): ``pos``, ``keep`` and ``dest``
    are one device's bits, and a token's drop may depend on other ranks'
    tokens. Each rank computes the rows ``c_rows`` of every expert it holds
    (``expert_range``) from the tokens gathered over the data axes (xr,
    whose backward reduce-scatters), three B5 launches per expert and
    group (``wo`` row-parallel under expert TP: its f32 partials summed
    over ``model``, then rounded). The rows are gathered back whole before
    the combine, which adds each token's terms in ascending expert order
    in the activation's dtype (:func:`combine`). ``aux`` is the
    Switch-style load-balance loss over each group's tokens (their
    probabilities gathered), meaned over the groups; its expert shares
    count dropped assignments too. Under :class:`Whole` every exchange is
    the identity and this is the single-device layer."""
    E, K = mcfg.e_total, mcfg.top_k
    Tl, d = xt.shape
    T = Tl * part.D
    Tg = T // G
    router = part.at_use(p.router, "moe.router")
    segs = _segments(part.d_index * Tl, Tl, Tg)
    probs, eidx, gate = [], [], []
    for _, a, b in segs:
        pr = router_probs(p, mcfg, xt if b - a == Tl else xt[a:b], router)
        ei = route(pr, K)
        gt = pr.gather(-1, ei)
        probs.append(pr)
        eidx.append(ei)
        gate.append(gt / gt.sum(-1, keepdim=True).clamp_min(1e-9))
    probs, eidx, gate = (t[0] if len(t) == 1 else torch.cat(t)
                         for t in (probs, eidx, gate))
    every = part.gather_ids(eidx)                               # (T, K)
    probs = part.gather_dp(probs, same_cotangent=True)          # (T, E)
    e_lo, e_hi = part.expert_range(E)
    c_lo, c_hi = part.c_rows(C)
    el, cl = e_hi - e_lo, c_hi - c_lo
    src, slots, auxes = [], [], []
    for g in range(G):
        order, se, _, _, _, dest = dispatch(every[g * Tg:(g + 1) * Tg], E, C)
        # group g's rows of the repeated global tokens; an empty row reads
        # the zero row T * K
        rows = source_rows(order, dest, E * C, T * K - g * Tg * K).view(
            E, C)[e_lo:e_hi, c_lo:c_hi]
        src.append(rows + g * Tg * K if g else rows)
        slot = token_slots(order, dest, Tg, K)
        # group g's rows of the (G * E * C + 1) outputs, the last row zero
        slots.append(slot if G == 1 else
                     torch.where(slot == E * C, G * E * C, slot + g * E * C))
        counts = torch.diff(starts_of(se, E), append=se.new_tensor([Tg * K]))
        auxes.append(E * torch.sum(counts.float() / (Tg * K)
                                   * probs[g * Tg:(g + 1) * Tg].mean(dim=0)))
    xg = part.gather_dp(xr)                                     # (T, d)
    buf = repeated(xg, K)[src[0] if G == 1 else torch.stack(src)]
    ho = expert_rows(p, buf.view(G, el, cl, d), part, (E, C))
    lo = part.d_index * Tl
    mine = [slots[g][lo + a - g * Tg:lo + b - g * Tg] for g, a, b in segs]
    out = combine(ho, eidx, gate, mine[0] if len(mine) == 1
                  else torch.cat(mine))
    aux = auxes[0] if G == 1 else torch.stack(auxes).mean()
    return out, aux


def expert_rows(p: MoE, buf: torch.Tensor, part: Partition,
                EC: tuple[int, int]) -> torch.Tensor:
    """The experts' outputs over this rank's (G, E_l, C_l, d) rows of the
    dispatch buffer, gathered over the mesh into (G * E * C + 1, d), the
    last row 0 (where dropped assignments point)."""
    G, el, cl, d = buf.shape
    (E, C), mesh = EC, part.mesh
    wi = _w(p.wi, "moe.wi", "moe.wi", part).unbind(0)
    wg = _w(p.wg, "moe.wg", "moe.wg", part).unbind(0)
    wo = _w(p.wo, "moe.wo", "moe.wo", part).unbind(0)
    f, fl = p.wi.shape[2] * (1 if part.ep else part.M), wi[0].shape[1]
    ho = []
    for g in range(G):
        _constrain_moe(buf[g], 0, part, (E, C, d))
        if MOE_SHARDING is not None:
            _constrain_moe(torch.empty(el, cl, fl, device="meta"), 1, part,
                           (E, C, f))
        for e, h in enumerate(buf[g]):
            hg, hi = silu(linear(h, wg[e])), linear(h, wi[e])
            ho.append(linear(hg * hi, wo[e]) if part.ep
                      else ops.matmul(hg * hi, wo[e]))
    zero = buf.new_zeros(1, d)
    if not part.ep:
        # expert TP: every expert's f32 partial product of wo summed over
        # ``model`` in one exchange, then rounded (row_parallel's rule)
        out = part.shd.psum(torch.stack(ho), mesh,
                            part.live("model")).to(buf.dtype)
    elif not part.live(part.dp + ("model",)):
        return torch.cat(ho + [zero])
    else:
        out = torch.stack(ho)
    # the outputs lie as the buffer (checked above); every rank gets them
    # all, so the combine adds each token's terms as one device does
    out = part.gather_dp(out.view(G, el, cl, d), dim=2)
    if part.ep and part.live("model"):
        out = part.shd.all_gather_tiled(out, mesh, "model", dim=1)
    return torch.cat([out.reshape(G * E * C, d), zero])


def shared_experts(p: MoE, mcfg: MoEConfig, xt: torch.Tensor,
                   part: Partition = WHOLE) -> torch.Tensor:
    """(T, d): ``silu(x wg_s) * (x wi_s)`` of every shared expert s (one
    B5 launch per expert and weight), contracted with ``shared_wo`` over
    (s, f) as one B5 product of K = s * f (the reference's ``tsf,sfd->td``
    einsum). On a placed model each rank computes its f / model columns of
    every shared expert and the contraction is row-parallel, as a dense
    FFN's."""
    T, d = xt.shape
    s = mcfg.n_shared
    wg = _w(p.shared_wg, "moe.shared_wg", "moe.shared_wg", part).unbind(0)
    wi = _w(p.shared_wi, "moe.shared_wi", "moe.shared_wi", part).unbind(0)
    h = torch.stack([silu(linear(xt, wg[i])) * linear(xt, wi[i])
                     for i in range(s)], dim=1)             # (T, s, f)
    wo = _w(p.shared_wo, "moe.shared_wo", "moe.shared_wo", part)
    fl = wo.shape[1]
    return part.row_parallel(h.reshape(T, s * fl), wo.reshape(s * fl, d))


def moe_ffn(p: MoE, cfg: LMConfig, x: torch.Tensor,
            part: Partition | None = None):
    """The capacity-bounded MoE layer: x (B, S, d) -> ``(out (B, S, d) in
    x's dtype, aux)``, the reference's ``moe_ffn``. With G > 1 groups
    (:func:`capacity`) each group is routed on its own and ``aux`` is the
    groups' mean. The shared experts' output (:func:`shared_experts`) is
    added to the routed one in x's dtype.

    Under a placed model's :class:`Partition`, x is this rank's rows of the
    batch, and G and C are those of the GLOBAL token count (B * S times the
    data ranks): the routed experts are :func:`_routed`'s, the result this
    rank's rows of one device's layer over the global batch. With
    :func:`set_moe_impl` set, the whole layer is that function's; it reads
    plain tensors as global values, so on a model placed on more than one
    rank it raises."""
    part = WHOLE if part is None else part
    if MOE_IMPL is not None:
        if part.size > 1:
            raise NotImplementedError(
                f"set_moe_impl's MoE layer (runtime.moe_a2a.make_a2a_moe) "
                f"reads plain tensors as the global values, and a model "
                f"placed on a mesh of {part.size} ranks holds this rank's "
                "shards: run the partitioner's MoE layer "
                "(set_moe_impl(None)), or the a2a on a model of whole "
                "tensors")
        return MOE_IMPL(p, cfg, x)
    mcfg = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    G, C = capacity(mcfg, B * S * part.D)
    # the experts see only their share of xt on each model rank (an
    # expert block, or f columns), the router all of it alike
    xr = part.replicated(xt)
    out, aux = _routed(p, mcfg, xt, xr, G, C, part)
    if mcfg.n_shared:
        out = out + shared_experts(p, mcfg, xr, part)
    return out.reshape(B, S, d), aux


def _layer(p: Block, cfg: LMConfig, x, positions, part: Partition,
           cache=None, cache_len=None):
    """One layer: ``(x, aux)``, aux the MoE loss (a 0-dim f32 tensor) or
    None for a dense layer; on this rank's shards under ``part``."""
    h = part.replicated(rms_norm(x, part.at_use(p.ln1, "ln1")))
    x = _constrain(x + attention_block(p, cfg, h, positions, part,
                                       cache=cache, cache_len=cache_len),
                   part)
    h = rms_norm(x, part.at_use(p.ln2, "ln2"))
    if cfg.moe is None:
        return _constrain(x + p.ffn(part.replicated(h), part), part), None
    f, aux = moe_ffn(p.moe, cfg, h, part)
    return _constrain(x + f, part), aux


def _sum_aux(auxes: list, device) -> torch.Tensor:
    """The layers' aux losses summed (0 for a dense model)."""
    return sum((a for a in auxes if a is not None),
               torch.zeros((), dtype=torch.float32, device=device))


# ----------------------------------------------------------------------
# full model
# ----------------------------------------------------------------------

def _embed(model: Transformer, part: Partition,
           ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``ids`` (in range): on a placed model this
    rank's d / model columns of them, gathered over ``model``."""
    return part.gather_model(part.at_use(model.embed, "embed")[ids])


def _head(model: Transformer, part: Partition,
          x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head: f32 logits, on a placed model this
    rank's vocab / model columns of them (never gathered)."""
    x = part.replicated(rms_norm(x, part.at_use(model.ln_f, "ln_f")))
    return linear(x, part.at_use(model.head, "head")).float()


@torch.inference_mode()
def forward(model: Transformer, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, vocab) in f32, aux). ``aux`` is the
    reference's MoE auxiliary loss summed over the layers: 0 for a dense
    model. A placed model (:class:`Partition`) takes this rank's rows of
    the batch and gives its (B / data, S, vocab / model) logits."""
    cfg = model.cfg
    part = partition_of(model)
    S = tokens.shape[1]
    x = _constrain(_embed(model, part, tokens), part)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    auxes = []
    for p in model.layers:
        x, aux = _layer(p, cfg, x, positions, part)
        auxes.append(aux)
    return _head(model, part, x), _sum_aux(auxes, x.device)


def train_forward(model: Transformer, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, vocab) in f32, aux), with autograd:
    :func:`forward`'s arithmetic outside ``inference_mode``, each layer
    under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (its
    kernels run again in the backward pass; a MoE layer routes again, on
    the same bits). ``aux`` is the layers' MoE loss, 0 for a dense
    model. A token id past the vocabulary takes the last row and passes
    no gradient to it, as the reference's clamped gather and its
    transpose, which drops an out-of-bounds update, do (``TokenStream``
    emits the id ``vocab`` now and then: its f32 CDF ends a little below
    1)."""
    cfg = model.cfg
    part = partition_of(model)
    S = tokens.shape[1]
    ids = tokens.long()
    inside = ((ids >= 0) & (ids < cfg.vocab))[..., None]
    x = part.at_use(model.embed, "embed")[ids.clamp(0, cfg.vocab - 1)]
    x = _constrain(part.gather_model(torch.where(inside, x, x.detach())),
                   part)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    auxes = []
    for p in model.layers:
        if cfg.remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer, p, cfg, x, positions, part, use_reentrant=False)
        else:
            x, aux = _layer(p, cfg, x, positions, part)
        auxes.append(aux)
    return _head(model, part, x), _sum_aux(auxes, x.device)


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
    part = partition_of(model)
    lab = labels.long()
    if part.M == 1:
        logz = torch.logsumexp(logits, dim=-1)
        vocab = logits.shape[-1]
        picked = logits.gather(-1, lab.clamp(0, vocab - 1)[..., None])[..., 0]
        label_logit = torch.where((lab >= 0) & (lab < vocab), picked, 0.0)
    else:
        logz, label_logit = _vocab_parallel_terms(part, logits, lab)
    loss = part.shd.pmean((logz - label_logit).mean(), part.mesh,
                          part.live(part.dp))
    return loss + aux_weight * aux


def _vocab_parallel_terms(part: Partition, logits: torch.Tensor,
                          lab: torch.Tensor):
    """``(logz, label_logit)`` per position from this rank's vocab / model
    logit columns: the max and the sum of exponentials all-reduced over
    ``model``, the label's logit taken on the rank owning its column (0
    elsewhere, and 0 everywhere for a label outside the vocabulary) and
    summed. The (B, S, vocab) logits are never gathered."""
    shd, mesh = part.shd, part.mesh
    vl = logits.shape[-1]
    lo = part.m * vl
    top = shd.all_reduce(logits.detach().amax(dim=-1), mesh, "model",
                         op="max")
    sumexp = shd.psum(torch.exp(logits - top[..., None]).sum(dim=-1), mesh,
                      "model")
    logz = top + torch.log(sumexp)
    loc = lab - lo
    own = (loc >= 0) & (loc < vl) & (lab < part.cfg.vocab)
    picked = logits.gather(-1, loc.clamp(0, vl - 1)[..., None])[..., 0]
    return logz, shd.psum(torch.where(own, picked, 0.0), mesh, "model")


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda", mesh=None) -> dict:
    """Zeroed KV cache ``{"k", "v"}`` in ``dtype`` (default ``cfg.dtype``),
    each (L, B, T, Hkv, dh). A cache of another dtype than the model's is
    attended in the cache's dtype (:func:`attention_block`). With ``mesh``,
    this rank's shard under ``runtime.sharding.lm_cache_spec``: the batch
    over the data axes, kv heads over ``model`` where they divide it."""
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layer, batch, max_len, cfg.n_kv, cfg.d_head)
    if mesh is not None:
        from ..runtime import sharding as shd
        spec = shd.lm_cache_spec(mesh, cfg.n_kv)["k"]
        shd.check_divides(shape, spec, mesh, "the KV cache")
        shape = shd.shard_shape(shape, spec, mesh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def abstract_cache(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """The KV cache on ``torch.device("meta")``: shapes and ``cfg.dtype``,
    nothing allocated (the reference's ``abstract_cache``)."""
    return init_cache(cfg, batch, max_len, device="meta")


@torch.inference_mode()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: dict,
                cache_len):
    """One decode step. tokens (B, 1); cache (L, B, T, Hkv, dh) x 2;
    ``cache_len`` an int (or 0-dim tensor) in [0, T). Returns
    ``(logits (B, vocab) in f32, cache)``; a MoE model's aux loss is
    dropped, as the reference drops it.

    Unlike the reference, which returns an updated copy of the cache, the
    new token's k/v are written into ``cache`` IN PLACE (slot
    ``cache_len`` of every layer), and the same dict is returned. A placed
    model takes this rank's rows of the batch and its shard of the cache
    (:func:`init_cache` with the mesh) and gives (B / data, vocab / model)
    logits."""
    cfg = model.cfg
    part = partition_of(model)
    B, S = tokens.shape
    T = cache["k"].shape[2]
    if cache["k"].shape[1] != B or cache["k"].shape[3] != part.hk:
        raise ValueError(f"a cache of {cache['k'].shape[1]} sequences and "
                         f"{cache['k'].shape[3]} kv heads for {B} sequences "
                         f"and {part.hk} kv heads on this rank")
    cache_len = int(cache_len)
    if S != 1:
        raise ValueError(f"decode_step takes one token per sequence, got {S}")
    if not 0 <= cache_len < T:
        raise ValueError(f"cache_len must lie in [0, {T}), got {cache_len}")
    x = _constrain(_embed(model, part, tokens), part)
    positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    for i, p in enumerate(model.layers):
        x, _ = _layer(p, cfg, x, positions, part,
                      cache=(cache["k"][i], cache["v"][i]),
                      cache_len=cache_len)
    return _head(model, part, x)[:, 0], cache
