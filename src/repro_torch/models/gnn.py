"""The GNN family on the port's B4 and B5 kernels: MeshGraphNet,
GraphSAGE, NequIP and MACE.

Counterpart of ``repro.models.gnn``: the same configs, the parameters
under the reference's names (``core.carry.gnn_params_from_reference``
flattens its nested dicts and lists into them: ``enc_node.0.w``,
``layers.3.edge_mlp.1.b``, ``layers.0.prod.s2``), all f32, and the same
arithmetic, so the reference's weights give its outputs. Where the
reference aggregates with ``jax.ops.segment_sum``, gathers with
``x[src]`` and projects with ``x @ w``, the port calls its kernels:

* every aggregation, degree count and per-graph energy sum is
  ``ops.segment_sum`` (B4);
* every row gather by an edge end is ``ops.gather_rows``, whose gradient
  is B4;
* each forward builds B4's plan (``ops.segment_plan``) once per id vector
  it sums by, and once for ``src`` where a gradient can flow (the
  gathers' gradients sum by it), and hands the plans to every layer and,
  through the kernels' Functions, to every backward pass;
* every dense product (each MLP layer, the radial MLPs, NequIP's and
  MACE's channel mixes, MACE's product-basis projections) is
  ``ops.matmul`` (B5, its f32 route).

The channel mixes ``nci,cd->ndi`` and ``ncij,cd->ndij`` are B5 products
on the irreps' contiguous (n * 3, C) and (n * 9, C) transposes. The
equivariant contractions themselves (``models/equivariant.py``) stay
plain PyTorch, as the reference keeps them in ``jnp.einsum``.

Serving runs each family's forward under ``torch.inference_mode()``;
training differentiates its loss. NequIP's and MACE's losses hold forces,
``-dE/dpos``, taken with ``create_graph=True``, so the train step's
gradient differentiates a gradient: B4 and B5 are twice differentiable
(``kernels/ops.py``), and the force term's gradient runs on them too.

A batch is the reference's unified graph batch as tensors on one device:
``node_feat`` (n, d) f32, ``src`` and ``dst`` (E,) int32 and, for a
padded batch, ``edge_mask`` (E,) f32 (0.0 on the padding edges, which
point at node 0); MeshGraphNet adds ``edge_feat`` (E, d_edge_in) and
``target`` (n, d_out), GraphSAGE ``labels`` and ``seed_mask``, NequIP and
MACE ``pos`` (n, 3), ``graph_id`` (n,), ``energy_target`` (graphs,) and
``force_target`` (n, 3).

On a ``(data, model)`` mesh (a model placed by ``runtime.sharding.
shard_params`` under ``gnn_param_specs``, or ``configs.init_params(mesh=)``)
a forward runs the reference's edge-parallel policy
(``runtime/sharding.py``'s GNN rules), partitioned by hand
(:class:`EdgeShard`, from :func:`partition_of`): each rank holds its ``E /
world`` edges (``src``, ``dst``, ``edge_feat``, ``edge_mask``), every node
tensor and parameter whole, the same on every rank. A node tensor or
parameter that enters the edge rows (a gather by an edge end, ``pos``,
MeshGraphNet's ``enc_edge`` and ``edge_mlp``, the geo layers' ``radial``
MLP) passes through ``grad_sum``, and every aggregation that leaves them
through ``psum``, so that every rank computes the whole graph's node
update and holds the whole gradient; a parameter used on node rows only
takes no sum. A mean divides after both its sums and its counts are
summed over the mesh. On a one-rank mesh nothing is exchanged and the
forward is the unsharded one bit for bit.

The reference's node-sharding hook (:func:`set_node_sharding`) pins each
aggregated node tensor to rows split over every mesh axis for XLA's
partitioner. Here, given ``runtime.sharding.named(mesh, P(all_axes))`` of
more than one rank, it switches a model placed on that mesh to the
node-sharded variant (:class:`NodeShard`): the edges still over every
axis, each rank's node state its ``n / world`` rows (the node count
zero-padded to a multiple of the world, the padding rows kept by no
output). Each aggregation is reduced and scattered to the node rows of
their rank in rank order (``sharding.sum_scatter``: its rows are the
edge-parallel ``psum``'s bit for bit), node-wise work (MLPs, norms, the
geo layers' mixes, the readouts) runs on this rank's rows with its
parameters through ``grad_sum``, and the node state is gathered whole
before each edge gather (``sharding.gather_tiled``; the two are each
other's backward, so NequIP's and MACE's forces differentiate through
them twice). Losses and energies sum this rank's rows, then ``psum``;
serve steps return this rank's node rows. At each aggregation the hook
checks the layout (``models.transformer.check_layout``): the identity on
one rank; a spec or a mesh other than the partition's raises
``NotImplementedError``, and so does the hook on a model not placed.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..kernels import ops
from ..runtime import sharding as shd
from . import equivariant as eq
from .transformer import check_layout

#: the aggregated node tensors' placement (rows over the mesh), checked
#: after every aggregation
NODE_SHARDING = None


def set_node_sharding(sharding):
    global NODE_SHARDING
    NODE_SHARDING = sharding


def _constrain_nodes(x: torch.Tensor, part=None) -> torch.Tensor:
    if NODE_SHARDING is not None:
        return check_layout(x, NODE_SHARDING,
                            None if part is None else part.node_layout(x))
    return x


# ======================================================================
# the edge-parallel partition
# ======================================================================

class EdgeShard:
    """How a GNN placed on ``mesh`` runs its forward on this rank's edges
    (the reference's GNN policy, ``runtime.sharding.gnn_batch_specs``):
    edges over every mesh axis, node state and parameters replicated.
    :meth:`rep` marks a replicated tensor entering the edge rows (its
    gradient there is this rank's share: ``grad_sum`` over the mesh),
    :meth:`agg` sums an aggregation of this rank's edges into the whole
    graph's (``psum``; its backward passes the replicated cotangent).
    Axes of one rank are left out, so a one-rank mesh, or none, exchanges
    nothing. The node-wise methods (:meth:`nodes`, :meth:`gather`,
    :meth:`node_rep`, :meth:`total`, ...) are what :class:`NodeShard`
    splits; here every node tensor is whole and they pass it on."""

    def __init__(self, mesh=None):
        sizes = shd.axis_sizes(mesh) if mesh is not None else {}
        self.mesh = mesh
        self.axes = tuple(a for a, n in sizes.items() if n > 1)
        self.size = math.prod(sizes.values())

    def rep(self, x: torch.Tensor) -> torch.Tensor:
        return shd.grad_sum(x, self.mesh, self.axes)

    def agg(self, x: torch.Tensor) -> torch.Tensor:
        return shd.psum(x, self.mesh, self.axes)

    def segments(self, n: int) -> int:
        """Rows an aggregation over ``n`` nodes sums into."""
        return n

    def segments_of(self, x: torch.Tensor) -> int:
        """:meth:`segments` of this rank's node state ``x``."""
        return x.shape[0]

    def nodes(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's node rows of a whole node input, as the node state
        holds them."""
        return x

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """A whole node input as the edges gather it (:meth:`segments`
        rows)."""
        return x

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's real node rows of a whole node input (a target, a
        label, a graph id)."""
        return x

    def real(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The real nodes' rows of this rank's node state ``x``."""
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The node state ``x`` as the edges gather it."""
        return self.rep(x)

    def node_rep(self, w: torch.Tensor) -> torch.Tensor:
        """A parameter used on node rows."""
        return w

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's node rows made the whole graph's."""
        return x

    def mean(self, x: torch.Tensor, count: int) -> torch.Tensor:
        """The mean over the whole graph of ``x``, this rank's node rows
        of ``count`` values in all."""
        return x.mean()

    def node_layout(self, x: torch.Tensor):
        """``(spec, global shape, mesh)`` of an aggregated node tensor as
        the partition lays it out (``check_layout``'s ``produced``): none,
        the node state being whole."""
        return None


class NodeShard(EdgeShard):
    """The node-sharded variant (the reference's :func:`set_node_sharding`
    hook at ``P(all_axes)``): the edges as :class:`EdgeShard`'s, the node
    state split into ``world`` equal row blocks, in the order of the
    ranks' combined index over the mesh axes (the first major), the node
    count zero-padded to a multiple of ``world``. :meth:`agg` reduces an
    aggregation and scatters its rows (``sum_scatter``, rank order),
    :meth:`gather` gathers the node state whole (``gather_tiled``), and
    :meth:`node_rep`, :meth:`total` and :meth:`mean` are ``grad_sum``
    and ``psum`` over the mesh."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.index = shd._combined_index(mesh, shd.all_axes(mesh))[0]

    def agg(self, x: torch.Tensor) -> torch.Tensor:
        return shd.sum_scatter(x, self.mesh, self.axes)

    def segments(self, n: int) -> int:
        return -(-n // self.size) * self.size

    def segments_of(self, x: torch.Tensor) -> int:
        return x.shape[0] * self.size

    def _span(self, n: int) -> tuple[int, int]:
        per = self.segments(n) // self.size
        return self.index * per, (self.index + 1) * per

    def nodes(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self._span(x.shape[0])
        out = x[lo:hi]
        if out.shape[0] < hi - lo:
            out = torch.cat([out, out.new_zeros((hi - lo - out.shape[0],
                                                 *x.shape[1:]))])
        return out

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.segments(x.shape[0]) - x.shape[0]
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self._span(x.shape[0])
        return x[lo:hi]

    def real(self, x: torch.Tensor, n: int) -> torch.Tensor:
        lo, hi = self._span(n)
        return x[:max(0, min(hi, n) - lo)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return shd.gather_tiled(x.contiguous(), self.mesh, self.axes)

    def node_rep(self, w: torch.Tensor) -> torch.Tensor:
        return shd.grad_sum(w, self.mesh, self.axes)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return shd.psum(x, self.mesh, self.axes)

    def mean(self, x: torch.Tensor, count: int) -> torch.Tensor:
        return self.total(x.sum()) / count

    def node_layout(self, x: torch.Tensor):
        return (shd.P(shd.all_axes(self.mesh)),
                (x.shape[0] * self.size, *x.shape[1:]), self.mesh)


#: the partition of no mesh: every edge on this device
WHOLE = EdgeShard()


def partition_of(model: nn.Module) -> EdgeShard:
    """The model's partition: without a ``mesh`` (set by
    ``runtime.sharding.shard_params``) :data:`WHOLE`; on one,
    :class:`NodeShard` where the node-sharding hook spans more than one
    rank, else :class:`EdgeShard`."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return WHOLE
    if NODE_SHARDING is not None and NODE_SHARDING.size > 1:
        return NodeShard(mesh)
    return EdgeShard(mesh)


# ======================================================================
# shared pieces
# ======================================================================

def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class Dense(nn.Module):
    """One MLP layer's parameters: ``w`` (d_in, d_out) and ``b`` (d_out,),
    the reference's ``{"w", "b"}``."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.w = _param((d_in, d_out), device)
        self.b = _param((d_out,), device)


def _mlp_params(dims: list[int], device) -> nn.ModuleList:
    """The reference's ``_mlp_init`` list: one :class:`Dense` per pair of
    consecutive ``dims``."""
    return nn.ModuleList(Dense(a, b, device)
                         for a, b in zip(dims[:-1], dims[1:]))


def _mlp(layers: nn.ModuleList, x: torch.Tensor,
         final_act: bool = False, rep=None) -> torch.Tensor:
    """The reference's ``_mlp``: ``x @ w + b`` per layer (B5), relu between
    the layers (and after the last with ``final_act``). ``rep`` (an
    :meth:`EdgeShard.rep`) takes each weight and bias where x holds edge
    rows."""
    for i, lyr in enumerate(layers):
        w, b = (lyr.w, lyr.b) if rep is None else (rep(lyr.w), rep(lyr.b))
        x = ops.matmul(x, w) + b
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def _plans(src: torch.Tensor, dst: torch.Tensor, n: int):
    """``(src, dst)`` for a forward over ``n`` nodes: ``dst`` as its B4 plan
    (every aggregation sums by it), ``src`` as its plan where a gradient
    can flow (the gradient of ``x[src]`` sums by it), else as it is (a
    forward only gathers by it)."""
    dst = ops.segment_plan(dst, n)
    if torch.is_grad_enabled():
        src = ops.segment_plan(src, n)
    return src, dst


def _layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis without scale or shift (the
    reference's ``_layernorm``)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


# ======================================================================
# MeshGraphNet  [arXiv:2010.03409]
# ======================================================================

@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4
    d_out: int = 3


class MGNLayer(nn.Module):
    """One processor layer: ``edge_mlp`` (3h -> h) and ``node_mlp``
    (2h -> h), each ``mlp_layers`` hidden layers of h."""

    def __init__(self, cfg: MGNConfig, device=None):
        super().__init__()
        h, hidden = cfg.d_hidden, [cfg.d_hidden] * cfg.mlp_layers
        self.edge_mlp = _mlp_params([3 * h] + hidden + [h], device)
        self.node_mlp = _mlp_params([2 * h] + hidden + [h], device)


class MeshGraphNet(nn.Module):
    """MeshGraphNet's parameters, named as the reference's tree:
    ``enc_node``, ``enc_edge``, ``dec`` and ``layers.<i>.edge_mlp``,
    ``node_mlp``, each a list of ``{w, b}``."""

    def __init__(self, cfg: MGNConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, hidden = cfg.d_hidden, [cfg.d_hidden] * cfg.mlp_layers
        self.enc_node = _mlp_params([cfg.d_node_in] + hidden + [h], device)
        self.enc_edge = _mlp_params([cfg.d_edge_in] + hidden + [h], device)
        self.dec = _mlp_params([h] + hidden + [cfg.d_out], device)
        self.layers = nn.ModuleList(MGNLayer(cfg, device)
                                    for _ in range(cfg.n_layers))


def mgn_outputs(model: MeshGraphNet, batch: dict) -> torch.Tensor:
    """The reference's ``mgn_forward`` with autograd: (n, d_out) f32.
    Encoders, then per layer the edge update from ``[e, x[src], x[dst]]``
    (two gathers), masked edges zeroed, the B4 sum of the edges into their
    ``dst`` and the node update from ``[x, agg]``; every MLP output layer
    normed; the decoder. One B4 plan for ``dst``, and one for ``src`` where
    a gradient can flow. On a mesh (:class:`EdgeShard`) the edge encoder,
    the edge MLPs and the node state gathered by the edges take
    ``grad_sum``, each layer's aggregation ``psum``; node-sharded
    (:class:`NodeShard`) the node rows are this rank's, and so are the
    outputs."""
    part = partition_of(model)
    n = batch["node_feat"].shape[0]
    ns = part.segments(n)
    src, dst = _plans(batch["src"], batch["dst"], ns)
    mask = batch.get("edge_mask")
    mask = mask[:, None] if mask is not None else 1.0
    x = _layernorm(_mlp(model.enc_node, part.nodes(batch["node_feat"]),
                        rep=part.node_rep))
    e = _layernorm(_mlp(model.enc_edge, batch["edge_feat"],
                        rep=part.rep)) * mask
    for lyr in model.layers:
        xe = part.gather(x)
        msg_in = torch.cat([e, ops.gather_rows(xe, src),
                            ops.gather_rows(xe, dst)], dim=-1)
        e = (e + _layernorm(_mlp(lyr.edge_mlp, msg_in, rep=part.rep))) * mask
        agg = _constrain_nodes(part.agg(ops.segment_sum(e, dst, ns)), part)
        x = x + _layernorm(_mlp(lyr.node_mlp, torch.cat([x, agg], dim=-1),
                                rep=part.node_rep))
    return part.real(_mlp(model.dec, x, rep=part.node_rep), n)


@torch.inference_mode()
def mgn_forward(model: MeshGraphNet, batch: dict) -> torch.Tensor:
    """:func:`mgn_outputs` for serving, under inference mode."""
    return mgn_outputs(model, batch)


def mgn_loss(model: MeshGraphNet, batch: dict) -> torch.Tensor:
    """The reference's ``mgn_loss``: the mean squared error against
    ``target``."""
    part = partition_of(model)
    target = batch["target"]
    return part.mean((mgn_outputs(model, batch) - part.rows(target)) ** 2,
                     target.numel())


# ======================================================================
# GraphSAGE (mean aggregator)  [arXiv:1706.02216]
# ======================================================================

@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41

    @property
    def param_count(self) -> int:
        """Weights and biases of every layer plus the head, exact."""
        h = self.d_hidden
        dims = [self.d_in] + [h] * (self.n_layers - 1)
        return sum(2 * d * h + h for d in dims) + h * self.n_classes


class SAGELayer(nn.Module):
    """One layer's parameters, named as the reference's layer dict."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.w_self = _param((d_in, d_out), device)
        self.w_neigh = _param((d_in, d_out), device)
        self.b = _param((d_out,), device)


class GraphSAGE(nn.Module):
    """GraphSAGE's parameters: ``layers.<i>.w_self``, ``w_neigh``, ``b``
    and ``head``, in f32."""

    def __init__(self, cfg: SAGEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
        self.layers = nn.ModuleList(SAGELayer(d, cfg.d_hidden, device)
                                    for d in dims)
        self.head = _param((cfg.d_hidden, cfg.n_classes), device)


def segment_mean(vals: torch.Tensor, ids, num: int,
                 part: EdgeShard = WHOLE) -> torch.Tensor:
    """Mean of the rows of ``vals`` (E, d) per segment id (``ids``: a
    vector or its B4 plan), 0 for a segment with no row: two B4 calls, the
    sums and the counts, each summed over ``part``'s mesh before the
    division (:func:`edge_mean`)."""
    s = ops.segment_sum(vals, ids, num)
    ones = torch.ones((vals.shape[0], 1), dtype=s.dtype, device=vals.device)
    return edge_mean(part, s, ops.segment_sum(ones, ids, num))


def edge_mean(part: EdgeShard, sums: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """The mean of the whole graph's edge rows per node from this rank's
    ``sums`` and ``counts``: both summed over the mesh, then divided (a
    count floored at 1). A mean of the ranks' own means would weigh each
    rank's edges alike whatever their count."""
    return part.agg(sums) / part.agg(counts).clamp_min(1.0)


def sage_layer(layer: SAGELayer, x: torch.Tensor, src, dst,
               mask: torch.Tensor | None,
               part: EdgeShard = WHOLE,
               x_edges: torch.Tensor | None = None) -> torch.Tensor:
    """One layer (``sage_forward``'s loop body): the mean of the in-edge
    neighbours' rows (masked edges counted out), both projections plus the
    bias, relu, and each row scaled to norm 1 (floored at 1e-6). ``src``
    and ``dst`` are id vectors or their B4 plans. On a mesh the node rows
    gathered by the edges take ``grad_sum`` and the mean's sums and counts
    ``psum``; the layer's parameters act on node rows only and take
    none. Node-sharded, ``x`` is this rank's rows: the edges gather
    ``x_edges`` (the input features, whole) or ``x`` gathered whole, the
    mean is scattered to this rank's rows and the parameters take
    ``grad_sum``."""
    n = part.segments_of(x)
    rows = ops.gather_rows(part.gather(x) if x_edges is None else x_edges,
                           src)
    if mask is not None:
        agg = edge_mean(part, ops.segment_sum(rows * mask[:, None], dst, n),
                        ops.segment_sum(mask[:, None], dst, n))
    else:
        agg = segment_mean(rows, dst, n, part)
    agg = _constrain_nodes(agg, part)
    x = (ops.matmul(x, part.node_rep(layer.w_self))
         + ops.matmul(agg, part.node_rep(layer.w_neigh))
         + part.node_rep(layer.b))
    x = torch.relu(x)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-6)


def sage_logits(model: GraphSAGE, batch: dict) -> torch.Tensor:
    """Logits (n, n_classes) in f32 of every node of ``batch``, with
    autograd: ``2 * n_layers`` B4 calls and ``2 * n_layers + 1`` B5
    calls, over one B4 plan for ``dst`` (and one for ``src`` where a
    gradient can flow) shared by the layers."""
    part = partition_of(model)
    feat = batch["node_feat"]
    n = feat.shape[0]
    src, dst = _plans(batch["src"], batch["dst"], part.segments(n))
    mask = batch.get("edge_mask")
    x = part.nodes(feat)
    for i, layer in enumerate(model.layers):
        x = sage_layer(layer, x, src, dst, mask, part,
                       x_edges=part.whole(feat) if i == 0 else None)
    return part.real(ops.matmul(x, part.node_rep(model.head)), n)


@torch.inference_mode()
def sage_forward(model: GraphSAGE, batch: dict) -> torch.Tensor:
    """:func:`sage_logits` for serving, under inference mode."""
    return sage_logits(model, batch)


def sage_loss(model: GraphSAGE, batch: dict) -> torch.Tensor:
    """The reference's ``sage_loss``: the mean over the seed nodes
    (``seed_mask``) of the negative log-softmax at each node's label
    (``labels``), the sum over the seeds divided by their count floored
    at 1."""
    part = partition_of(model)
    logp = torch.log_softmax(sage_logits(model, batch), dim=-1)
    nll = -logp.gather(-1, part.rows(batch["labels"]).long()[:, None])[:, 0]
    w = part.rows(batch["seed_mask"]).to(torch.float32)
    return part.total((nll * w).sum()) / part.total(w.sum()).clamp_min(1.0)


# ======================================================================
# NequIP (Cartesian-irrep adaptation, l_max = 2)  [arXiv:2101.03164]
# ======================================================================

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_species: int = 16
    radial_hidden: int = 64
    bf16_state: bool = False    # node irreps rounded to bf16 between layers


class Interaction(nn.Module):
    """One equivariant layer's parameters (the reference's
    ``_interaction_init``): the ``radial`` MLP (n_rbf -> radial_hidden ->
    3 * C * N_PATHS), the channel mixers ``mix_s``, ``mix_v``, ``mix_t``
    (C, C) and the ``gates`` MLP (C -> 2C)."""

    def __init__(self, C: int, n_rbf: int, radial_hidden: int, device=None):
        super().__init__()
        self.radial = _mlp_params([n_rbf, radial_hidden, 3 * C * eq.N_PATHS],
                                  device)
        self.mix_s = _param((C, C), device)
        self.mix_v = _param((C, C), device)
        self.mix_t = _param((C, C), device)
        self.gates = _mlp_params([C, 2 * C], device)


class ProductBasis(nn.Module):
    """MACE's B-basis projections back to C channels: ``s2``, ``s3``
    (3C, C), ``v2``, ``t2``, ``v3``, ``t3`` (2C, C)."""

    def __init__(self, C: int, device=None):
        super().__init__()
        for name, k in (("s2", 3), ("v2", 2), ("t2", 2), ("s3", 3),
                        ("v3", 2), ("t3", 2)):
            setattr(self, name, _param((k * C, C), device))


class GeoLayer(Interaction):
    """A MACE layer: an :class:`Interaction` and its ``prod``."""

    def __init__(self, C: int, n_rbf: int, radial_hidden: int, device=None):
        super().__init__(C, n_rbf, radial_hidden, device)
        self.prod = ProductBasis(C, device)


class GeoModel(nn.Module):
    """NequIP's or MACE's parameters (by ``cfg``'s type), named as the
    reference's tree: ``embed`` (d_species -> C), ``layers.<i>`` (an
    :class:`Interaction`, with ``prod`` for MACE) and ``readout`` (C -> C
    -> 1)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.d_hidden
        layer = GeoLayer if isinstance(cfg, MACEConfig) else Interaction
        self.embed = _mlp_params([cfg.d_species, C], device)
        self.layers = nn.ModuleList(
            layer(C, cfg.n_rbf, cfg.radial_hidden, device)
            for _ in range(cfg.n_layers))
        self.readout = _mlp_params([C, C, 1], device)


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("nk...,kc->nc...", x, w)`` as one B5 product: x (n, K,
    *irrep) on its contiguous (n * r, K) transpose (r = 3 or 9 irrep
    components), times w (K, C), back to (n, C, *irrep)."""
    n, K, *irrep = x.shape
    r = math.prod(irrep)
    xt = x.reshape(n, K, r).transpose(1, 2).contiguous().reshape(n * r, K)
    y = ops.matmul(xt, w).reshape(n, r, w.shape[1])
    return y.transpose(1, 2).reshape(n, w.shape[1], *irrep)


def _interaction(lyr: Interaction, C: int, s, V, T, src, dst, rbf, rhat, Y2,
                 n: int, mask=None, part: EdgeShard = WHOLE):
    """One equivariant message-passing layer (the reference's
    ``_interaction``, shared by NequIP and MACE): per-edge path weights
    from the radial MLP (masked edges send nothing), the senders' irreps
    gathered as (n, C), (n, 3C) and (n, 9C) rows, the three tensor-product
    messages, their B4 sums into ``dst`` as (E, C), (E, 3C) and (E, 9C)
    rows, the channel mixes, and the gated nonlinearity. ``src`` and
    ``dst`` are id vectors or their B4 plans, ``n`` the rows they sum
    into. On a mesh the radial MLP and the three gathered irreps take
    ``grad_sum``, the three sums ``psum``; the mixes and gates act on node
    rows and take none. Node-sharded, s, V and T are this rank's rows,
    gathered whole for the edges, the sums scattered to this rank's rows
    and the mixes and gates take ``grad_sum``."""
    E = rbf.shape[0]
    nl = s.shape[0]
    rw = _mlp(lyr.radial, rbf, rep=part.rep).reshape(E, 3, C, eq.N_PATHS)
    if mask is not None:
        rw = rw * mask[:, None, None, None]
    # bf16 state (bf16_state) meets f32 edge terms in f32, as jnp promotes
    s_e = ops.gather_rows(part.gather(s), src).float()
    V_e = ops.gather_rows(part.gather(V.reshape(nl, 3 * C)), src).float(
    ).reshape(E, C, 3)
    T_e = ops.gather_rows(part.gather(T.reshape(nl, 9 * C)), src).float(
    ).reshape(E, C, 3, 3)
    m_s = (eq.tp_to_scalar(s_e, V_e, T_e, rhat, Y2) * rw[:, 0]).sum(-1)
    m_v = torch.einsum("ecip,ecp->eci",
                       eq.tp_to_vector(s_e, V_e, T_e, rhat, Y2), rw[:, 1])
    m_t = torch.einsum("ecijp,ecp->ecij",
                       eq.tp_to_tensor(s_e, V_e, T_e, rhat, Y2), rw[:, 2])
    a_s = _constrain_nodes(part.agg(ops.segment_sum(m_s.contiguous(), dst,
                                                    n)), part)
    a_v = _constrain_nodes(part.agg(ops.segment_sum(
        m_v.reshape(E, 3 * C).contiguous(), dst, n)), part).reshape(
        nl, C, 3)
    a_t = _constrain_nodes(part.agg(ops.segment_sum(
        m_t.reshape(E, 9 * C).contiguous(), dst, n)), part).reshape(
        nl, C, 3, 3)
    s2 = s + ops.matmul(a_s, part.node_rep(lyr.mix_s))
    V2 = V + _mix(a_v, part.node_rep(lyr.mix_v))
    T2 = T + _mix(a_t, part.node_rep(lyr.mix_t))
    gates = _mlp(lyr.gates, s2, rep=part.node_rep)
    return eq.gated_nonlin(s2, V2, T2, gates)


def _product_basis(prod: ProductBasis, s, V, T, rep):
    """MACE's correlation orders 2 and 3 (``mace_forward``'s loop body
    after the interaction): the order-2 products of (s, V, T), projected
    to C channels on B5; the order-2 products of those projections (order
    3), projected; both added to the features. ``rep`` (the partition's
    :meth:`EdgeShard.node_rep`) takes each projection."""
    w = {k: rep(getattr(prod, k)) for k in ("s2", "v2", "t2", "s3", "v3",
                                            "t3")}
    s2b, v2b, t2b = eq.correlation_products(s, V, T)
    ps2 = ops.matmul(s2b, w["s2"])
    pv2, pt2 = _mix(v2b, w["v2"]), _mix(t2b, w["t2"])
    s3b, v3b, t3b = eq.correlation_products(ps2, pv2, pt2)
    return (s + ps2 + ops.matmul(s3b, w["s3"]),
            V + pv2 + _mix(v3b, w["v3"]),
            T + pt2 + _mix(t3b, w["t3"]))


def geo_outputs(model: GeoModel, batch: dict, n_graphs: int | None = None):
    """The reference's ``nequip_forward`` / ``mace_forward`` with autograd:
    ``(energy (graphs,), (s, V, T))``. The edge vectors ``pos[src] -
    pos[dst]`` (two gathers), their basis and radial features, the
    embedding, the layers (MACE's with its product basis; with
    ``bf16_state`` the features rounded to bf16 after each), the readout
    per atom, and the B4 sum of the atoms' energies by ``graph_id``. One
    B4 plan each for ``dst`` and ``graph_id``, and one for ``src`` where a
    gradient can flow. On a mesh ``pos`` takes ``grad_sum`` where the
    edges gather it (the forces then sum every rank's edges); the
    energies, a sum over node rows, take no ``psum``. Node-sharded, the
    energies sum this rank's atoms, then ``psum``, and (s, V, T) are this
    rank's rows."""
    cfg = model.cfg
    part = partition_of(model)
    feat = batch["node_feat"]
    n = feat.shape[0]
    ns = part.segments(n)
    ng = n_graphs if n_graphs is not None else batch["energy_target"].shape[0]
    C = cfg.d_hidden
    src, dst = _plans(batch["src"], batch["dst"], ns)
    graph_id = ops.segment_plan(part.rows(batch["graph_id"]), ng)
    pos = part.rep(part.whole(batch["pos"]))
    rvec = ops.gather_rows(pos, src) - ops.gather_rows(pos, dst)
    d, rhat, Y2 = eq.edge_basis(rvec)
    rbf = eq.bessel_rbf(d, cfg.n_rbf, cfg.cutoff)
    s = _mlp(model.embed, part.nodes(feat), rep=part.node_rep)
    V = feat.new_zeros((s.shape[0], C, 3))
    T = feat.new_zeros((s.shape[0], C, 3, 3))
    mace = isinstance(cfg, MACEConfig)
    for lyr in model.layers:
        s, V, T = _interaction(lyr, C, s, V, T, src, dst, rbf, rhat, Y2, ns,
                               mask=batch.get("edge_mask"), part=part)
        if mace:
            s, V, T = _product_basis(lyr.prod, s, V, T, rep=part.node_rep)
        if cfg.bf16_state:
            s, V, T = (x.to(torch.bfloat16) for x in (s, V, T))
    atom_e = part.real(_mlp(model.readout, s.float(), rep=part.node_rep), n)
    energy = part.total(ops.segment_sum(atom_e, graph_id, ng))[:, 0]
    return energy, tuple(part.real(x, n) for x in (s, V, T))


@torch.inference_mode()
def geo_forward(model: GeoModel, batch: dict, n_graphs: int | None = None):
    """:func:`geo_outputs` for serving, under inference mode: the
    reference's ``(energy, (s, V, T))``."""
    return geo_outputs(model, batch, n_graphs)


def energy_and_forces(model: GeoModel, batch: dict,
                      create_graph: bool = False):
    """``(energy, forces)``: the per-graph energies and ``-dE/dpos`` (n, 3)
    of the summed energy, by autograd on a ``pos`` leaf (the reference's
    ``jax.value_and_grad`` of ``energy_fn``). With ``create_graph`` the
    energies and forces keep their graph, so a loss of them differentiates
    again (through B4 and B5 twice); without, both come detached."""
    with torch.enable_grad():
        pos = batch["pos"].detach().requires_grad_(True)
        energy, _ = geo_outputs(model, {**batch, "pos": pos})
        (dpos,) = torch.autograd.grad(energy.sum(), pos,
                                      create_graph=create_graph)
    return (energy if create_graph else energy.detach()), -dpos


def geo_loss_terms(model: GeoModel, batch: dict):
    """``(e_loss, f_loss)``: the mean squared errors of the energies
    against ``energy_target`` and of the forces against
    ``force_target``, the forces with their graph."""
    energy, forces = energy_and_forces(model, batch, create_graph=True)
    e_loss = ((energy - batch["energy_target"]) ** 2).mean()
    f_loss = ((forces - batch["force_target"]) ** 2).mean()
    return e_loss, f_loss


def geo_loss(model: GeoModel, batch: dict) -> torch.Tensor:
    """The reference's ``nequip_loss`` / ``mace_loss``: ``e_loss + 10 *
    f_loss``."""
    e_loss, f_loss = geo_loss_terms(model, batch)
    return e_loss + 10.0 * f_loss


# ======================================================================
# MACE (Cartesian adaptation, correlation order 3)  [arXiv:2206.07697]
# ======================================================================

@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    d_species: int = 16
    radial_hidden: int = 64
    bf16_state: bool = False    # node irreps rounded to bf16 between layers


# ======================================================================
# the family's surface
# ======================================================================

#: each config type's model, serve forward and loss
MODELS = {MGNConfig: MeshGraphNet, SAGEConfig: GraphSAGE,
          NequIPConfig: GeoModel, MACEConfig: GeoModel}
FORWARDS = {MGNConfig: mgn_forward, SAGEConfig: sage_forward,
            NequIPConfig: geo_forward, MACEConfig: geo_forward}
LOSSES = {MGNConfig: mgn_loss, SAGEConfig: sage_loss,
          NequIPConfig: geo_loss, MACEConfig: geo_loss}


def model_of(cfg, device=None) -> nn.Module:
    """An uninitialised model of ``cfg`` (a GNN config) on ``device``."""
    return MODELS[type(cfg)](cfg, device)


@torch.no_grad()
def init_params(cfg, generator: torch.Generator,
                device="cuda", mesh=None) -> nn.Module:
    """A model of ``cfg`` with the reference's initial distributions
    (``mgn_init``, ``sage_init``, ``nequip_init``, ``mace_init``): every
    weight N(0, 1) / sqrt(its first dimension, the fan-in), every bias 0.
    Drawn from ``generator``, which lives on ``device``; the bits are not
    the reference's. With ``mesh`` the model is placed on it, every
    parameter replicated (``runtime.sharding.gnn_param_specs``): every rank
    drawing from a generator seeded alike holds the same bits."""
    model = model_of(cfg, device)
    for name, p in model.named_parameters():
        if name.endswith(".b"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device).div_(p.shape[0] ** 0.5))
    if mesh is not None:
        shd.shard_params(model, shd.gnn_param_specs(model), mesh)
    return model
