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
:func:`sage_params_from_reference` a reference GraphSAGE's, and
:func:`adamw_state_from_reference` the reference AdamW state of either.
"""

from __future__ import annotations

import numpy as np
import torch

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


def lm_params_from_reference(tree) -> dict[str, torch.Tensor]:
    """The port's LM state dict from a reference LM params pytree.

    ``tree`` is ``repro.models.transformer.init_params``'s dict as numpy
    arrays (``embed``, ``head``, ``ln_f``, and ``layers`` with every array
    stacked on a leading layer axis, ``ffn`` nested), bf16 given either
    as ml_dtypes' bfloat16 or as float32. Returns ``{name: tensor}`` under
    the names of ``models.transformer.Transformer`` (``layers.<i>.wq``,
    ``layers.<i>.ffn.wi``, ...), each tensor of its array's dtype exactly,
    for ``Transformer.load_state_dict``."""
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
    return state


def sage_params_from_reference(tree) -> dict[str, torch.Tensor]:
    """The port's GraphSAGE state dict from a reference GraphSAGE params
    pytree (``repro.models.gnn.sage_init``'s dict as numpy arrays:
    ``layers``, a list of ``{w_self, w_neigh, b}``, and ``head``). Returns
    ``{name: tensor}`` under the names of ``models.gnn.GraphSAGE``
    (``layers.<i>.w_self``, ..., ``head``), each of its array's dtype, for
    ``GraphSAGE.load_state_dict``."""
    state = {"head": _tensor(tree["head"])}
    for i, layer in enumerate(tree["layers"]):
        for name, val in layer.items():
            state[f"layers.{i}.{name}"] = _tensor(val)
    return state


def adamw_state_from_reference(state) -> dict:
    """The port's AdamW state (``optim.adamw.init_state``'s form) from the
    reference's ``{"mu", "nu", "step"}`` (``repro.optim.adamw``'s state as
    numpy arrays): ``mu`` and ``nu``, pytrees of the params' structure,
    become ``{name: tensor}`` under the port's parameter names (through
    :func:`lm_params_from_reference` for an LM's tree, which has
    ``embed``, else :func:`sage_params_from_reference`), ``step`` an int32
    0-dim tensor. CPU tensors; ``.to(device)`` them for the card."""
    carry = (lm_params_from_reference if "embed" in state["mu"]
             else sage_params_from_reference)
    return {"mu": carry(state["mu"]), "nu": carry(state["nu"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}
