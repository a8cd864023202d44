"""Elastic scaling: place a job's restored state onto a changed mesh. The
port's ``repro.runtime.elastic``.

Checkpoints store tensors in host layout (``checkpoint.manager``) beside
*logical* partition specs (axis names, not ranks), so a restart on
another set of devices only needs a new mesh with the same axis names:

    mesh_old (2,16,16) --checkpoint--> mesh_new (1,16,16) or (4,16,16)

:func:`remesh` turns each spec into placements on the new mesh and
distributes the restored host tensors as DTensors. Divisibility is not
required (DTensor's ``Shard`` cuts uneven chunks, as XLA pads them), so an
odd number of survivors still mounts. ``CheckpointManager.restore(device=)``
followed by :func:`remesh` of its host tree is the elastic path.
"""

from __future__ import annotations

import numpy as np
import torch

from .sharding import P, NamedPlacement, _axes, axis_names, named, place


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples, a
    :class:`P` being a leaf."""
    if isinstance(tree, P) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def spec_tree_to_shardings(spec_tree, mesh):
    """Each spec of ``spec_tree`` as a :class:`NamedPlacement` on
    ``mesh``."""
    return _tree_map(lambda s: named(mesh, s), spec_tree)


def degrade(spec: P, names) -> P:
    """``spec`` with every axis that ``names`` lacks dropped: an entry
    left with no axis is replicated."""
    def keep(part):
        kept = tuple(a for a in _axes(part) if a in names)
        if isinstance(part, tuple):
            return kept or None
        return kept[0] if kept else None
    return P(*(keep(part) for part in spec))


def remesh(host_tree, spec_tree, new_mesh):
    """The restored host tensors (or numpy arrays) of ``host_tree`` as
    DTensors on ``new_mesh`` under the same logical specs. Axis names in a
    spec but absent from the new mesh degrade to replication (a multi-pod
    checkpoint restored on one pod)."""
    names = set(axis_names(new_mesh))
    shardings = _tree_map(lambda s: NamedPlacement(new_mesh,
                                                   degrade(s, names)),
                          spec_tree)

    def put(a, sharding):
        t = torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else torch.as_tensor(a)
        return place(t, sharding)

    return _tree_map(put, host_tree, shardings)
