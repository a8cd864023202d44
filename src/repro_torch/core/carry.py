"""Carry an index built by the JAX reference package into the port.

The index is this system's counterpart of a model's weights: the
reference builds it (``repro.core.pecb_index.build_stratified_index``)
and the port must serve exactly it. :func:`from_reference` takes it in
either of two plain forms, so nothing here imports the reference:

* the reference ``StratifiedPECB``'s dataclass fields as a dict of numpy
  arrays and scalars, with ``strata`` as the dict of its
  ``StratifiedCoreTable``'s fields (or None) — giving the port's
  :class:`StratifiedPECB` (host), or its upload when ``device`` is given;
  a per-k ``PECBIndex``'s fields the same way, with ``versions`` as the
  dict of its ``VersionStore``'s fields (or None) — giving the port's
  :class:`PECBIndex` (an epoch to extend or shrink, or to upload);
* the reference ``batch_query._host_layout``'s ``(meta, arrays)`` pair —
  giving a :class:`DeviceIndex` on ``device``.

:func:`core_times_from_reference` carries the construction's output one
step earlier: a reference ``CoreTimeTable`` or ``StratifiedCoreTable`` as
its dataclass fields, ready for the port's forest builders
(``build_stratified_index(g, strata=...)``, ``build_pecb_index(g, k,
tab)``).

:func:`lm_params_from_reference` carries a reference LM's weights (the
JAX params pytree as numpy arrays) into the port's state dict,
:func:`gnn_params_from_reference` a reference GNN's (MeshGraphNet,
GraphSAGE, NequIP, MACE), :func:`mind_params_from_reference` MIND's, and
:func:`adamw_state_from_reference` the reference AdamW state of any of
them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime import sharding as shd
from .batch_query import DeviceIndex, device_index, to_device
from .core_time import CoreTimeTable, StratifiedCoreTable
from .pecb_index import PECBIndex, StratifiedPECB
from .query_api import VersionStore


def from_reference(state, *, device=None
                   ) -> StratifiedPECB | PECBIndex | DeviceIndex:
    """The port's index from a reference index's plain state (see the
    module docstring); ``device=None`` keeps a field dict on the host."""
    if isinstance(state, tuple):
        meta, arrays = state
        if device is None:
            raise ValueError("a (meta, arrays) device layout needs a device")
        return device_index(meta, arrays, device)
    fields = dict(state)
    if "ks" in fields:
        strata = fields.pop("strata", None)
        index = StratifiedPECB(
            **fields, strata=(core_times_from_reference(strata)
                              if strata is not None else None))
    else:
        versions = fields.pop("versions", None)
        index = PECBIndex(**fields, versions=(
            VersionStore(**versions) if versions is not None else None))
    return index if device is None else to_device(index, device)


def core_times_from_reference(fields: dict
                              ) -> CoreTimeTable | StratifiedCoreTable:
    """The port's core-time table from a reference table's dataclass
    fields (numpy arrays and scalars): a ``StratifiedCoreTable`` when the
    fields name its strata (``ks``), else a per-k ``CoreTimeTable``."""
    cls = StratifiedCoreTable if "ks" in fields else CoreTimeTable
    fields = dict(fields)
    if "ks" in fields:
        fields["ks"] = tuple(int(k) for k in fields["ks"])
    return cls(**fields)


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype; ml_dtypes' bfloat16
    (what ``np.asarray`` makes of a bf16 JAX array) as torch.bfloat16, bit
    for bit."""
    a = np.array(a, copy=True, order="C")       # writable, owned
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_reference(tree, mesh=None) -> dict[str, torch.Tensor]:
    """The port's LM state dict from a reference LM params pytree.

    ``tree`` is ``repro.models.transformer.init_params``'s dict as numpy
    arrays (``embed``, ``head``, ``ln_f``, and ``layers`` with every array
    stacked on a leading layer axis, ``ffn`` nested), bf16 given either
    as ml_dtypes' bfloat16 or as float32. Returns ``{name: tensor}`` under
    the names of ``models.transformer.Transformer`` (``layers.<i>.wq``,
    ``layers.<i>.ffn.wi``, ...), each tensor of its array's dtype exactly,
    for ``Transformer.load_state_dict``. With ``mesh``, this rank's shard
    of each (``runtime.sharding.shard_params`` under
    ``lm_param_spec_tree``), for ``models.transformer.placed``."""
    state = {name: _tensor(tree[name]) for name in ("embed", "head", "ln_f")}

    def split(prefix: str, node: dict) -> None:
        for name, val in node.items():
            if isinstance(val, dict):
                split(f"{prefix}{name}.", val)
                continue
            stacked = _tensor(val)
            for i in range(stacked.shape[0]):
                state[f"layers.{i}.{prefix}{name}"] = stacked[i]

    split("", tree["layers"])
    if mesh is None:
        return state
    return shd.shard_params(state, shd.lm_param_spec_tree(state, mesh), mesh)


def gnn_params_from_reference(tree) -> dict[str, torch.Tensor]:
    """The port's state dict of a GNN from a reference GNN params pytree
    (``repro.models.gnn``'s ``mgn_init``, ``sage_init``, ``nequip_init``
    or ``mace_init`` as numpy arrays): nested dicts and lists flattened
    into dotted names, a list's items by position (``enc_node.0.w``,
    ``layers.3.edge_mlp.1.b``, ``layers.0.prod.s2``, ``head``), the names
    of ``models.gnn``'s modules; each tensor of its array's dtype, for
    ``load_state_dict``."""
    state = {}

    def walk(prefix: str, node) -> None:
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, (list, tuple))
                 else None)
        if items is None:
            state[prefix[:-1]] = _tensor(node)
            return
        for key, val in items:
            walk(f"{prefix}{key}.", val)

    walk("", tree)
    return state


def mind_params_from_reference(tree, mesh=None) -> dict[str, torch.Tensor]:
    """The port's MIND state dict from the reference's ``mind_init`` dict
    as numpy arrays: ``item_embed`` and ``S``, each tensor of its array's
    dtype (f32), for ``MIND.load_state_dict``. With ``mesh``, this rank's
    shard of each (``runtime.sharding.shard_params`` under
    ``mind_param_specs``: its rows of ``item_embed``, ``S`` whole), for a
    model placed on the mesh."""
    state = {name: _tensor(tree[name]) for name in ("item_embed", "S")}
    if mesh is None:
        return state
    return shd.shard_params(state, shd.mind_param_specs(state), mesh)


def adamw_state_from_reference(state, mesh=None) -> dict:
    """The port's AdamW state (``optim.adamw.init_state``'s form) from the
    reference's ``{"mu", "nu", "step"}`` (``repro.optim.adamw``'s state as
    numpy arrays): ``mu`` and ``nu``, pytrees of the params' structure,
    become ``{name: tensor}`` under the port's parameter names, ``step``
    an int32 0-dim tensor. The carrier is picked by the tree's structure:
    an LM's ``layers`` is a dict of arrays stacked on a layer axis
    (:func:`lm_params_from_reference`), a GNN's a list of per-layer dicts
    (:func:`gnn_params_from_reference`; NequIP and MACE have an ``embed``
    too, an MLP where an LM's is a table), MIND's a flat dict with an
    ``item_embed`` (:func:`mind_params_from_reference`). CPU tensors;
    ``.to(device)`` them for the card. With ``mesh`` (an LM's or MIND's),
    the moments are this rank's shards under the parameters' specs
    (``lm_opt_spec_tree``, ``mind_param_specs``), as
    :func:`lm_params_from_reference` and :func:`mind_params_from_reference`
    place the parameters."""
    mu = state["mu"]
    carry = (mind_params_from_reference if "item_embed" in mu else
             lm_params_from_reference if isinstance(mu.get("layers"), dict)
             else None)
    if mesh is not None:
        if carry is None:
            raise NotImplementedError(
                "moments placed on a mesh: a GNN's are whole on every "
                "rank; carry them without a mesh")
        carry = functools.partial(carry, mesh=mesh)
    elif carry is None:
        carry = gnn_params_from_reference
    return {"mu": carry(state["mu"]), "nu": carry(state["nu"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}
