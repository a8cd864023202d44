"""Partition-spec policies per architecture family and the runtime's
collectives: the port's ``repro.runtime.sharding`` (DESIGN.md §4).

Mesh axes: single-pod ``('data','model')`` = (16, 16); multi-pod
``('pod','data','model')`` = (2, 16, 16) (``launch.mesh``).

The policies are the reference's rules, keyed by the port's parameter
names (``layers.<i>.wq``: the port keeps no stacked L axis, so a layer's
spec is the reference's without its leading ``None``):

* **LM**: 2-D FSDP x TP. Weight matrices shard their d_model side over
  ``data`` and their head or ffn side over ``model``; MoE experts shard
  over ``model`` (EP) where the expert count divides the axis, and inside
  each expert (TP) where it does not.
* **GNN**: edge-parallel. Edge arrays shard over every mesh axis; node
  state and parameters are replicated (under the node-sharding hook the
  node state's rows are split over every axis too:
  ``models.gnn.NodeShard``).
* **RecSys**: the item table's rows over ``model``, looked up by
  :func:`make_vp_take` (:func:`vp_lookup` on a placed model's shard:
  ``models.recsys.Partition``); everything else data-parallel.

A spec (:class:`P`) is a tuple of axis names (or tuples of them, or
``None``) per dimension, as ``PartitionSpec``. :func:`named` turns one into
the DTensor placements of a ``DeviceMesh``. In the reference the specs are
hints to XLA's partitioner. PyTorch has no such partitioner, and the
port's kernels take plain tensors through ctypes, where no ``DTensor``
can enter. So the model-wide specs place parameters and batches
(:func:`shard_params`, each rank keeping its shards as tensors of their
own; :func:`unshard_params` gathers them back; the dry run's per-device
bytes, ``runtime.elastic.remesh``), and the LM's step, dense or MoE,
is partitioned by hand on those shards (``models.transformer.Partition``:
FSDP over ``data`` through :func:`gather_at_use`, Megatron TP over
``model``, experts over ``model`` or TP inside them); the models' hooks
check layouts against it.

Besides it, what runs at any number of ranks is what the reference
writes as explicit ``shard_map`` bodies: :func:`make_vp_take`, the
all-to-all MoE (``runtime.moe_a2a``) and the compressed gradient mean
(``optim.compression``). :func:`shard_map` runs such a body on each
rank's shard. Every collective of the runtime goes through this module
(:func:`all_reduce`, :func:`all_gather`, :func:`gather`,
:func:`reduce_scatter`, :func:`reduce_scatter_over`, :func:`all_to_all`),
which counts calls and result bytes per kind under the reference's kind
names (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``): the dry run's collective bytes and
``chip_smoke.py`` read them (:func:`collective_counts`). On ``meta``
tensors a collective is counted and shaped, and nothing is sent.

The differentiable collectives state their backward for the way the
bodies use them, where the value after the collective is the same on
every rank of the group and everything downstream of it is computed
alike on each (so each rank holds the full cotangent):

* :func:`psum` sums over the group; its backward passes the cotangent
  through unchanged (summing it again would count it once per rank),
  as a :func:`grad_sum`: where that cotangent is differentiated again
  (``create_graph``), each rank's terms of it are summed;
* :func:`pmean` means; its backward divides by the group's size;
* :func:`all_gather_tiled` gathers; its backward takes this rank's
  chunk of the cotangent;
* :func:`gather_at_use` gathers a weight whose users differ by rank (each
  data rank's rows of the batch); its backward reduce-scatters;
* :func:`all_to_all_tiled` exchanges; its backward is the inverse
  exchange;
* :func:`gather_tiled` gathers dim 0 over several axes where each rank
  uses the whole differently (MIND's targets, a GNN's node rows); its
  backward is :func:`sum_scatter`, the sum in rank order of which each
  rank keeps its rows, and that one's backward is the gather again;
* :func:`grad_sum` is the identity forward and sums the gradient over
  the group: it marks a value replicated over the group but used on
  different data by each rank (a table shard over the batch axes, the
  router over every token chunk, a GNN's node state gathered by each
  rank's edges). Its backward is :func:`psum` of the cotangent. Each is
  the other's transpose and each one's backward is the other, so a
  gradient taken with ``create_graph`` (NequIP's and MACE's forces) is
  differentiated once more through the collectives correctly.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

from ..kernels import ops

class P(tuple):
    """A partition spec: per dimension an axis name, a tuple of axis
    names, or ``None`` (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


# ----------------------------------------------------------------------
# meshes: a DeviceMesh, or a description with .shape and .axis_names
# ----------------------------------------------------------------------

def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of a mesh description
    whose ``shape`` maps names to sizes (``launch.mesh.MeshShape``)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def dp_axes(mesh):
    """Axes carrying the batch (data-parallel) dimension."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def all_axes(mesh):
    return axis_names(mesh)


def _axes(part) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


class NamedPlacement:
    """A spec on a mesh: the counterpart of ``NamedSharding``. For a
    ``DeviceMesh``, :attr:`placements` are its DTensor placements, one per
    mesh axis: ``Shard(d)`` where tensor dimension d is split over that
    axis, ``Replicate()`` elsewhere."""

    def __init__(self, mesh, spec: P):
        names = axis_names(mesh)
        seen = [a for part in spec for a in _axes(part)]
        for a in seen:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, the mesh "
                                 f"has {names}")
        if len(set(seen)) != len(seen):
            raise ValueError(f"spec {spec} names an axis twice")
        self.mesh, self.spec = mesh, P(*spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        where = {a: d for d, part in enumerate(self.spec)
                 for a in _axes(part)}
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in axis_names(self.mesh))

    @property
    def size(self) -> int:
        """Ranks of the mesh."""
        return mesh_size(self.mesh)

    def __repr__(self) -> str:
        return f"NamedPlacement({axis_sizes(self.mesh)}, {self.spec!r})"


def named(mesh, spec: P) -> NamedPlacement:
    return NamedPlacement(mesh, spec)


def place(x: torch.Tensor, sharding: NamedPlacement):
    """``x`` (the global tensor) as a DTensor under ``sharding``, on the
    mesh's device."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    return distribute_tensor(x.to(mesh.device_type), mesh,
                             list(sharding.placements))


def shard_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """Per-device shape of a global ``shape`` under ``spec``: each split
    dimension ceil-divided by its axes' product (XLA pads uneven shards;
    DTensor's ``Shard`` gives the same largest shard)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // math.prod(sizes[a] for a in _axes(part)))
                 for n, part in zip(shape, spec))


def shard_bytes(shape, itemsize: int, spec: P, mesh) -> int:
    """Bytes of the largest per-device shard of a global tensor."""
    return math.prod(shard_shape(shape, spec, mesh)) * int(itemsize)


# ----------------------------------------------------------------------
# ranks, groups and the counted collectives
# ----------------------------------------------------------------------

def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def _combined_index(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(index, count) of this rank over several axes, the first major."""
    sizes = axis_sizes(mesh)
    idx, count = 0, 1
    for a in axes:
        idx = idx * sizes[a] + axis_index(mesh, a)
        count *= sizes[a]
    return idx, count


_COUNTS: dict = collections.defaultdict(lambda: {"calls": 0, "bytes": 0})


def reset_collectives() -> None:
    """Set every collective count to 0."""
    _COUNTS.clear()


def collective_counts() -> dict:
    """``{kind: {"calls", "bytes"}}`` since the last reset: calls and
    result bytes (bytes received per device, the reference's convention)
    of every collective the runtime made."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def _count(kind: str, result: torch.Tensor) -> None:
    _COUNTS[kind]["calls"] += 1
    _COUNTS[kind]["bytes"] += result.numel() * result.element_size()


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (``op="max"``: the largest) of ``x`` over the ranks of ``axes``
    (a name or a tuple of them), as a new tensor: one all-reduce per
    axis. A sum adds the ranks' values in rank order, whatever the
    tensor's size (:func:`_sum_in_rank_order`), so an element's bits do
    not depend on where it lies in the tensor: a decode step's rows equal
    the same rows of a prefill's."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce sums or takes the max, not {op!r}")
    out = x
    for a in _axes(axes):
        _count("all-reduce", out)
        if out.device.type == "meta":
            continue
        if op == "max":
            out = out.clone() if out is x else out
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(mesh, a))
        else:
            out = _sum_in_rank_order(out, mesh, a)
    return x.clone() if out is x else out


#: below this many bytes a sum in rank order over more than two ranks
#: gathers every rank's whole tensor (one collective, n - 1 tensors in);
#: from it on, it exchanges chunks and gathers their sums (two
#: collectives, the bytes of a ring all-reduce). Over two ranks the bytes
#: are the same and the gather always runs. ``bench_mesh_sum.py`` times
#: both routes on each side of it.
GATHER_SUM_BYTES = 4 << 20


def _sum_in_rank_order(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, each element added in
    rank order, ``((x_0 + x_1) + x_2) + ...``, by one of two routes with
    the same bits: every rank's tensor gathered and added here (small
    tensors, or two ranks), or (:func:`_exchange_sum`) chunk j of every
    rank sent to rank j, added there and the sums gathered back. NCCL's
    own all-reduce adds in an order that follows the element's offset in
    the message, so the same row summed in a message of another size
    rounds otherwise."""
    n = axis_sizes(mesh)[axis]
    if n == 1:
        return x
    group = _group(mesh, axis)
    flat = x.reshape(-1)
    if n > 2 and flat.numel() * flat.element_size() >= GATHER_SUM_BYTES:
        return _exchange_sum(flat, n, group).view(x.shape)
    every = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(every, flat, group=group)
    parts = every.view(n, -1)
    out = parts[0] + parts[1]
    for j in range(2, n):
        out += parts[j]
    return out.view(x.shape)


def _exchange_sum(flat: torch.Tensor, n: int, group) -> torch.Tensor:
    """:func:`_sum_in_rank_order` of a flat tensor by chunks: all-to-all
    (rank j gets chunk j of every rank, the tensor zero-padded to ``n``
    equal chunks only where ``n`` does not divide it), the chunks added in
    sender order (:func:`_chunk_sum`), all-gather of the sums."""
    m = flat.numel()
    chunk = -(-m // n)
    send = flat
    if chunk * n != m:
        send = flat.new_zeros(n * chunk)
        send[:m] = flat
    acc = _chunk_sum(send, n, group)
    got = torch.empty_like(send)
    dist.all_gather_into_tensor(got, acc, group=group)
    return got[:m]


def _chunk_sum(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """Chunk j of ``x`` along dim 0 (``n`` equal chunks) summed over the
    ``n`` ranks of ``group`` on rank j: all-to-all, then the received
    chunks added in sender order, ``((c_0 + c_1) + c_2) + ...``, the adds
    of :func:`_sum_in_rank_order` on each element."""
    got = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(got, x.contiguous(), group=group)
    parts = got.view(n, x.shape[0] // n, *x.shape[1:])
    acc = parts[0] + parts[1]
    for j in range(2, n):
        acc += parts[j]
    return acc


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated along dim 0, in rank
    order."""
    n = axis_sizes(mesh)[axis]
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _count("all-gather", out)
    if out.device.type != "meta":
        # all_gather_single is the newer name of all_gather_into_tensor
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, x.contiguous(), group=_group(mesh, axis))
    return out


def gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated along ``dim``, in rank
    order, as a new contiguous tensor. Along a dimension other than 0 the
    gathered chunks are put back in order along it (rows of an ``attn.wo``
    shard gathered over ``data`` are column blocks, not stacked rows)."""
    dim = dim % x.dim()
    n = axis_sizes(mesh)[axis]
    if dim == 0:
        return all_gather(x, mesh, axis)
    flat = all_gather(x, mesh, axis)                      # (n * x0, ...)
    shape = list(x.shape)
    shape[dim] *= n
    return flat.view(n, *x.shape).movedim(0, dim).reshape(shape)


def gather_over(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``x`` gathered over several axes along ``dim``, in the order of
    their combined index (the first axis major): one :func:`gather` per
    axis, the minor first. No gradient: for integers (a MoE layer's expert
    ids over the data axes)."""
    for a in reversed(_axes(axes)):
        x = gather(x, mesh, a, dim)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, of which this rank
    keeps its chunk along ``dim`` (``n`` equal chunks, in rank order), as
    a new contiguous tensor: the transpose of :func:`gather`."""
    dim = dim % x.dim()
    n = axis_sizes(mesh)[axis]
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter splits dim {dim} ({x.shape[dim]}) "
                         f"into {n} equal chunks")
    rows = x.movedim(dim, 0).contiguous()
    out = rows.new_empty((rows.shape[0] // n, *rows.shape[1:]))
    _count("reduce-scatter", out)
    if out.device.type != "meta":
        scatter = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        scatter(out, rows, group=_group(mesh, axis))
    return out.movedim(0, dim).contiguous()


def reduce_scatter_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a name or a tuple, the
    first major), of which this rank keeps its chunk along dim 0 (as many
    equal chunks as the axes have ranks, in the order of their combined
    index), as a new tensor: one reduce-scatter per axis, the major first,
    each adding the ranks' chunks in rank order (:func:`_chunk_sum`). Its
    rows are those of :func:`all_reduce`'s sum bit for bit, which also
    sums the axes in order, each in rank order; NCCL's own
    reduce-scatter (:func:`reduce_scatter`) adds in another order."""
    out = x
    for a in _axes(axes):
        n = axis_sizes(mesh)[a]
        if out.shape[0] % n:
            raise ValueError(f"reduce_scatter_over splits dim 0 "
                             f"({out.shape[0]}) into {n} equal chunks")
        if out.device.type == "meta" or n == 1:
            out = out[:out.shape[0] // n].clone()
        else:
            out = _chunk_sum(out, n, _group(mesh, a))
        _count("reduce-scatter", out)
    return x.clone() if out is x else out


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunk j of ``x`` along dim 0 (``n`` equal chunks) goes to rank j of
    ``axis``; the result holds the chunks received, in sender order."""
    n = axis_sizes(mesh)[axis]
    if x.shape[0] % n:
        raise ValueError(f"all_to_all splits dim 0 ({x.shape[0]}) into "
                         f"{n} equal chunks")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _count("all-to-all", out)
    if out.device.type != "meta":
        dist.all_to_all_single(out, x.contiguous(), group=_group(mesh, axis))
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        # the cotangent as it is, marked as the replicated value it is: a
        # gradient taken with create_graph passes it on to each rank's own
        # terms, whose second-order cotangents grad_sum then sums
        return _GradSum.apply(g, ctx.mesh, ctx.axes), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = math.prod(axis_sizes(mesh)[a] for a in _axes(axes))
        return all_reduce(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the differentiable sum, so that a gradient taken with
        # create_graph (NequIP's and MACE's forces) differentiates through
        # it again
        return _PSum.apply(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim = dim % x.dim()
        ctx.size, ctx.index = x.shape[ctx.dim], axis_index(mesh, axis)
        return gather(x, mesh, axis, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None,
                None, None)


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


class _GatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return gather_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        # differentiable, so that a gradient taken with create_graph
        # (NequIP's and MACE's forces) differentiates through it again
        return _SumScatter.apply(g, ctx.mesh, ctx.axes), None, None


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return reduce_scatter_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _GatherTiled.apply(g, ctx.mesh, ctx.axes), None, None


def psum(x, mesh, axes):
    """Sum over ``axes``; the backward passes the cotangent through."""
    return _PSum.apply(x, mesh, axes) if _axes(axes) else x


def pmean(x, mesh, axes):
    """Mean over ``axes``; the backward divides by their size."""
    return _PMean.apply(x, mesh, axes) if _axes(axes) else x


def grad_sum(x, mesh, axes):
    """The identity, whose backward sums the gradient over ``axes``."""
    return _GradSum.apply(x, mesh, axes) if _axes(axes) else x


def all_gather_tiled(x, mesh, axis: str, dim: int = 0):
    """All-gather along ``dim``; the backward keeps this rank's chunk."""
    return _AllGather.apply(x, mesh, axis, dim)


def gather_at_use(x, mesh, axis: str, dim: int = 0):
    """All-gather along ``dim`` (:func:`gather`) whose backward is a
    reduce-scatter (:func:`reduce_scatter`): the cotangent summed over the
    group, this rank's chunk kept. This is FSDP's gather of a weight at
    use, where each rank's cotangent comes from other rows of the batch
    (or, for kv weights gathered over ``model``, from other query heads),
    so every rank's contribution must be added; :func:`all_gather_tiled`,
    which keeps the chunk alone, is right only where every rank holds the
    same cotangent."""
    return _GatherAtUse.apply(x, mesh, axis, dim)


def gather_tiled(x, mesh, axes):
    """``x`` gathered along dim 0 over ``axes`` (:func:`gather_over`, the
    first axis major), each rank's use of the whole its own: the backward
    is :func:`sum_scatter` of the cotangent (every rank's cotangent of
    this rank's rows, added in rank order)."""
    return _GatherTiled.apply(x, mesh, axes) if _axes(axes) else x


def sum_scatter(x, mesh, axes):
    """:func:`reduce_scatter_over` (the sum over ``axes``, this rank's
    chunk of dim 0 kept); the backward is :func:`gather_tiled` of the
    cotangent.
    Each is the other's transpose and each one's backward is the other."""
    return _SumScatter.apply(x, mesh, axes) if _axes(axes) else x


def all_to_all_tiled(x, mesh, axis: str):
    """All-to-all over dim 0's chunks; the backward sends them back."""
    return _AllToAll.apply(x, mesh, axis)


# ----------------------------------------------------------------------
# shard_map: a local body on each rank's shard
# ----------------------------------------------------------------------

def local_shard(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """This rank's shard of the global tensor ``x`` under ``spec`` (a view:
    each split dimension cut into ceil-divided chunks, as DTensor's
    ``Shard`` cuts it)."""
    for d, part in enumerate(spec):
        axes = _axes(part)
        if not axes:
            continue
        idx, count = _combined_index(mesh, axes)
        step = -(-x.shape[d] // count)
        lo = min(idx * step, x.shape[d])
        x = x.narrow(d, lo, min(step, x.shape[d] - lo))
    return x


def to_local(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """The local shard a body works on: a DTensor's own local tensor (its
    placements must be ``spec``'s), or this rank's shard of a plain
    tensor, which stands for the global value on every rank. The plain
    tensor's gradient is summed over the axes it was split on, so that
    each rank holds the gradient of the whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        want = named(mesh, spec).placements
        if tuple(x.placements) != want:
            raise ValueError(f"a DTensor placed {tuple(x.placements)}, the "
                             f"body takes {want}")
        return x.to_local()
    split = tuple(a for part in spec for a in _axes(part))
    return local_shard(grad_sum(x, mesh, split), mesh, spec)


def check_divides(shape, spec: P, mesh, what: str) -> None:
    """Raise ``NotImplementedError`` unless every split dimension of
    ``shape`` divides evenly over its axes: the partitioner places even
    shards only (XLA pads uneven ones)."""
    sizes = axis_sizes(mesh)
    for d, part in enumerate(spec):
        count = math.prod(sizes[a] for a in _axes(part))
        if shape[d] % count:
            raise NotImplementedError(
                f"{what}: dim {d} of {tuple(shape)} does not split evenly "
                f"over {count} ranks of {_axes(part)} ({spec})")


def shard_of(x: torch.Tensor, mesh, spec: P, what: str = "a tensor"
             ) -> torch.Tensor:
    """This rank's shard of the global ``x`` under ``spec`` as a tensor of
    its own: contiguous (B5's and B6's operands are read with their
    shapes' strides, never a view's) and owning its storage, so the
    whole tensor can be freed. ``x`` itself where the spec keeps it
    whole."""
    check_divides(x.shape, spec, mesh, what)
    local = local_shard(x, mesh, spec)
    if local.shape == x.shape and x.is_contiguous():
        return x
    return local.clone(memory_format=torch.contiguous_format)


def set_param(module: torch.nn.Module, name: str, t: torch.Tensor) -> None:
    """Replace the parameter ``name`` (dotted) of ``module`` by ``t``,
    keeping its ``requires_grad``."""
    owner, _, leaf = name.rpartition(".")
    mod = module.get_submodule(owner) if owner else module
    old = mod._parameters[leaf]
    mod._parameters[leaf] = torch.nn.Parameter(
        t.detach(), requires_grad=old.requires_grad)


@torch.no_grad()
def shard_params(params, specs: dict, mesh):
    """The counterpart of ``jax.device_put(params, NamedSharding)``: this
    rank's shard of every leaf (:func:`shard_of`), ``specs`` giving each
    name its spec. A module is placed IN PLACE (each parameter replaced by
    its shard, ``module.mesh`` set) and returned; a name -> tensor dict
    gives a new dict."""
    if isinstance(params, torch.nn.Module):
        for name, p in list(params.named_parameters()):
            set_param(params, name, shard_of(p, mesh, specs[name], name))
        params.mesh = mesh
        return params
    return {n: shard_of(t, mesh, specs[n], n) for n, t in params.items()}


@torch.no_grad()
def unshard_params(params, specs: dict, mesh) -> dict:
    """The inverse of :func:`shard_params`: ``{name: the whole tensor}``
    on every rank, each leaf's shards gathered over the axes of its spec
    (a dimension split over several axes gathered minor axis first)."""
    tree = _named_shapes(params)
    out = {}
    for name, t in tree.items():
        full = t.detach()
        for d, part in enumerate(specs[name]):
            for a in reversed(_axes(part)):
                full = gather(full, mesh, a, d)
        out[name] = full
    return out


def shard_map(f, *, mesh, in_specs, out_specs):
    """``f`` run on each rank's shards of its arguments (:func:`to_local`),
    returning its local results; ``out_specs`` says how they lie on the
    mesh (each result of rank at least its spec's length)."""

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"the body takes {len(in_specs)} arguments, got "
                            f"{len(args)}")
        outs = f(*(to_local(a, mesh, s) for a, s in zip(args, in_specs)))
        single = isinstance(out_specs, P)
        for o, s in zip((outs,) if single else outs,
                        (out_specs,) if single else out_specs):
            if o.dim() < len(s):
                raise ValueError(f"a result of rank {o.dim()} under spec {s}")
        return outs

    return run


# ----------------------------------------------------------------------
# LM family
# ----------------------------------------------------------------------

def _named_shapes(params) -> dict:
    """name -> tensor of a module's parameters, or a dict as given."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lm_param_spec_tree(params, mesh) -> dict:
    """``{name: P}`` for a transformer's parameters (a ``Transformer`` or
    a name -> tensor dict), the reference's rules per layer."""
    model_size = axis_sizes(mesh)["model"]

    def spec_for(name: str, shape) -> P:
        keys = name.split(".")
        leaf, in_layer = keys[-1], keys[0] == "layers"
        if leaf in ("embed", "head") and not in_layer:
            return P(None, "model")
        if leaf == "ln_f" and not in_layer:
            return P(None)
        if in_layer:
            if leaf in ("ln1", "ln2"):
                return P(None)
            if leaf in ("wq", "wk", "wv"):
                return P("data", "model")
            if leaf == "wo" and len(shape) == 2 and "moe" not in keys \
                    and "ffn" not in keys:
                return P("model", "data")
            if leaf in ("bq", "bk", "bv"):
                return P("model")
            if "ffn" in keys:
                if leaf in ("wi", "wg"):
                    return P("data", "model")
                if leaf == "wo":
                    return P("model", "data")
            if "moe" in keys:
                if leaf == "router":
                    return P("data", None)
                # EP when the expert count divides the model axis (dbrx:
                # 16 % 16); otherwise TP inside each expert (qwen2-moe: 60
                # experts do not divide 16)
                ep = shape[0] % model_size == 0
                if leaf in ("wi", "wg"):                     # (E, d, f)
                    return P("model", "data", None) if ep else \
                        P(None, "data", "model")
                if leaf == "wo":                             # (E, f, d)
                    return P("model", None, "data") if ep else \
                        P(None, "model", "data")
                if leaf in ("shared_wi", "shared_wg"):       # (S, d, f)
                    return P(None, "data", "model")
                if leaf == "shared_wo":                      # (S, f, d)
                    return P(None, "model", "data")
        raise ValueError(f"no sharding rule for parameter {name} shape "
                         f"{tuple(shape)}")

    return {n: spec_for(n, t.shape) for n, t in _named_shapes(params).items()}


def lm_opt_spec_tree(param_specs: dict) -> dict:
    """Adam moments share the parameter specs; the step is replicated."""
    return {"mu": param_specs, "nu": param_specs, "step": P()}


def lm_batch_specs(mesh) -> dict:
    dp = dp_axes(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_spec(mesh, n_kv: int) -> dict:
    """The KV cache (L, B, T, Hkv, dh): batch over DP; kv heads over
    ``model`` only where they divide it (glm4's 2, dbrx's 8 kv heads stay
    whole)."""
    dp = dp_axes(mesh)
    head = "model" if n_kv % axis_sizes(mesh)["model"] == 0 else None
    spec = P(None, dp, None, head, None)
    return {"k": spec, "v": spec}


# ----------------------------------------------------------------------
# GNN family
# ----------------------------------------------------------------------

_GNN_EDGE_KEYS = ("src", "dst", "edge_feat", "edge_mask")


def gnn_batch_specs(batch: dict, mesh) -> dict:
    """Edge arrays over every mesh axis, everything else replicated: each
    rank's edges are the ``E / world`` rows at its index over all axes,
    the first major (``models.gnn.EdgeShard`` runs the forward on
    them)."""
    ax = all_axes(mesh)
    return {name: (P(ax, *([None] * (t.dim() - 1))) if name in _GNN_EDGE_KEYS
                   else P(*([None] * t.dim())))
            for name, t in batch.items()}


def gnn_param_specs(params) -> dict:
    return {n: P() for n in _named_shapes(params)}


# ----------------------------------------------------------------------
# RecSys family
# ----------------------------------------------------------------------

def mind_param_specs(params) -> dict:
    return {"item_embed": P("model", None), "S": P()}


def mind_batch_specs(batch: dict, mesh, retrieval: bool = False) -> dict:
    dp = dp_axes(mesh)

    def spec_for(name, t):
        if retrieval and name == "cand_ids":       # (C,) candidate slab
            return P(dp)
        if retrieval:                              # (1, H) user history
            return P(*([None] * t.dim()))
        return P(dp, *([None] * (t.dim() - 1)))

    return {name: spec_for(name, t) for name, t in batch.items()}


def make_vp_take(mesh, table_axis: str = "model", leading=None):
    """The vocab-parallel lookup: ``take_fn(table, ids) -> (*ids.shape,
    d)`` with the table's rows split over ``table_axis``. Each rank
    gathers the rows it owns (``ops.gather_rows``, whose gradient is B4),
    zeroes the others, and the partial rows are summed over the axis
    (:func:`psum`). ``leading`` splits the ids' first dimension (the DP
    batch); the result is this rank's rows of it.

    An id outside ``[0, n)`` gives a zero row and no gradient (ids ``n``,
    ``-1``, ``-n-1`` alike), as the reference's vp take does; ``ops.take``
    gives NaN rows and wraps ``[-n, 0)``. For ids in range on one rank the
    two are bit-equal. The table's gradient is the single-device one at
    every world size: the sum's backward passes the cotangent through, and
    the table shard, replicated over the ``leading`` axes, has its
    gradient summed over them (:func:`grad_sum`)."""
    def local(table_shard, ids):
        return vp_lookup(table_shard, ids, mesh, table_axis, leading)

    def take_fn(table, ids):
        parts = axis_sizes(mesh)[table_axis]
        if table.shape[0] % parts:
            raise ValueError(f"the vp take splits {table.shape[0]} rows "
                             f"over {parts} ranks of {table_axis!r}: they "
                             "must divide")
        return shard_map(local, mesh=mesh,
                         in_specs=(P(table_axis, None),
                                   P(leading, *([None] * (ids.dim() - 1)))),
                         out_specs=P(leading, *([None] * ids.dim())))(
            table, ids)

    return take_fn


def vp_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh,
              table_axis: str = "model", leading=None) -> torch.Tensor:
    """:func:`make_vp_take`'s body on one rank: ``(*ids.shape, d)`` rows
    of the whole table by this rank's ``ids``, from ``table_shard``, this
    rank's rows of the table split over ``table_axis``. The rows it owns
    are gathered (``ops.gather_rows``, the others as -1, whose gradient,
    B4, drops them), the others zeroed, and the partial rows summed over
    the axis (:func:`psum`: one owned row plus zeros, its bits). The shard
    is marked replicated over the ``leading`` axes, which split the ids
    (:func:`grad_sum`: its gradient is summed over them)."""
    vl = table_shard.shape[0]
    lo = axis_index(mesh, table_axis) * vl
    loc = ids.reshape(-1).long() - lo
    ok = (loc >= 0) & (loc < vl)
    rows = ops.gather_rows(grad_sum(table_shard, mesh, _axes(leading)),
                           torch.where(ok, loc, -1))
    rows = torch.where(ok[:, None], rows, 0.0)
    return psum(rows, mesh, table_axis).view(*ids.shape, -1)
