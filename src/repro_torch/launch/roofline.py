"""Roofline terms of a dry-run trace: the port's ``repro.launch.roofline``.

All quantities are per device:

  compute_s    = FLOPs_per_device / peak FLOP/s (bf16)
  memory_s     = bytes_per_device / HBM bandwidth
  collective_s = collective_result_bytes_per_device / link bandwidth

with the H100's constants (``launch.mesh.HW``). The reference reads its
numbers from a compiled XLA module (``analyze_compiled``); the port has
no compiler between the model and the card, so :func:`analyze_trace` runs
the step once on ``meta`` tensors (shapes only; every kernel wrapper
takes its plain version there and launches nothing) and counts what the
trace does:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  ``mm``, ``bmm``, attention, convolutions), the plain versions' products
  standing for the kernels';
* bytes accessed: the operand plus output bytes of every aten op that is
  not a view (a view moves nothing);
* the peak of live bytes: the arguments, plus every tensor the trace
  creates from its creation until it is freed;
* collective bytes and calls per kind: ``runtime.sharding``'s counter,
  the result bytes of every collective the runtime made.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..runtime import sharding as shd
from .mesh import HW


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, *, model_flops_global: float,
                   n_devices: int, hw: dict = HW) -> dict:
    """The reference's terms and ratios, under ``hw``'s constants."""
    compute_s = flops_per_dev / hw["peak_flops_bf16"]
    memory_s = bytes_per_dev / hw["hbm_bw"]
    collective_s = coll_bytes_per_dev / hw["link_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    hlo_flops_global = flops_per_dev * n_devices
    return {
        **terms,
        "dominant": dominant,
        "model_flops": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "useful_flop_ratio": (model_flops_global / hlo_flops_global
                              if hlo_flops_global else 0.0),
        "step_time_lb_s": max(terms.values()),
        "roofline_fraction": (compute_s / max(terms.values())
                              if max(terms.values()) > 0 else 0.0),
    }


def _tensors(tree):
    """The tensors of a tree of dicts, lists and tuples (a module's
    parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Bytes accessed by every non-view aten op, and the live bytes of the
    tensors created under the mode (each counted from its creation until
    it is freed), with their peak."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.ops = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False):
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        self.ops += 1
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes,
                                                               outs))
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen or t._is_view():
                continue                # in place, or an alias
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def analyze_trace(fn, args: tuple, *, model_flops_global: float,
                  n_devices: int = 1, hw: dict = HW) -> dict:
    """Run ``fn(*args)`` once (``meta`` tensors: nothing is computed) and
    return the reference's record keys from what it did: FLOPs and bytes
    per device, the collectives (``{"bytes", "counts", "total"}`` by kind),
    ``memory`` (argument, output and temporary bytes, the peak of live
    bytes) and the roofline terms."""
    arg_bytes = sum(_nbytes(t) for t in _tensors(args))
    shd.reset_collectives()
    counter = TraceCounter()
    flops = FlopCounterMode(display=False)
    with flops, counter:
        out = fn(*args)
    coll = shd.collective_counts()
    ids = {id(t) for t in _tensors(args)}
    out_bytes = sum(_nbytes(t) for t in _tensors(out) if id(t) not in ids)
    collectives = {"bytes": {k: v["bytes"] for k, v in coll.items()},
                   "counts": {k: v["calls"] for k, v in coll.items()},
                   "total": int(sum(v["bytes"] for v in coll.values()))}
    total_flops = float(flops.get_total_flops())
    byts = float(counter.bytes_accessed)
    return {
        "flops_per_device": total_flops,
        "bytes_per_device": byts,
        "collectives": collectives,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": counter.peak,
                   "peak_live_bytes": arg_bytes + counter.peak,
                   "generated_code_size_in_bytes": None},
        "aten_ops": counter.ops,
        "roofline": roofline_terms(total_flops, byts, collectives["total"],
                                   model_flops_global=model_flops_global,
                                   n_devices=n_devices, hw=hw),
    }
