"""Carry an index built by the JAX reference package into the port.

The index is this system's counterpart of a model's weights: the
reference builds it (``repro.core.pecb_index.build_stratified_index``)
and the port must serve exactly it. :func:`from_reference` takes it in
either of two plain forms, so nothing here imports the reference:

* the reference ``StratifiedPECB``'s dataclass fields as a dict of numpy
  arrays and scalars, with ``strata`` as the dict of its
  ``StratifiedCoreTable``'s fields (or None) — giving the port's
  :class:`StratifiedPECB` (host), or its upload when ``device`` is given;
* the reference ``batch_query._host_layout``'s ``(meta, arrays)`` pair —
  giving a :class:`DeviceIndex` on ``device``.

:func:`core_times_from_reference` carries the construction's output one
step earlier: a reference ``CoreTimeTable`` or ``StratifiedCoreTable`` as
its dataclass fields, ready for the port's forest builders
(``build_stratified_index(g, strata=...)``, ``build_pecb_index(g, k,
tab)``).
"""

from __future__ import annotations

from .batch_query import DeviceIndex, device_index, to_device
from .core_time import CoreTimeTable, StratifiedCoreTable
from .pecb_index import StratifiedPECB


def from_reference(state, *, device=None) -> StratifiedPECB | DeviceIndex:
    """The port's index from a reference index's plain state (see the
    module docstring); ``device=None`` keeps a field dict on the host."""
    if isinstance(state, tuple):
        meta, arrays = state
        if device is None:
            raise ValueError("a (meta, arrays) device layout needs a device")
        return device_index(meta, arrays, device)
    fields = dict(state)
    strata = fields.pop("strata", None)
    sx = StratifiedPECB(
        **fields,
        strata=StratifiedCoreTable(**strata) if strata is not None else None)
    return sx if device is None else to_device(sx, device)


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
