"""Int8 error-feedback gradient compression for the data-parallel mean:
the port's ``repro.optim.compression``.

Scheme (1-bit-Adam family, in int8):
  1. the residual-corrected gradient ``g' = g + error``;
  2. per-tensor symmetric int8 quantization ``q = round(g' / s)``, ``s =
     max|g'| / 127`` (+ 1e-12);
  3. the mean over the data-parallel group: the int8 values summed as
     int32 (exact, in any order), the scales meaned in f32, then
     ``sum * mean_scale / n``;
  4. the new error ``g' - dequant(q)``, kept on the rank and added at the
     next step.

``torch.round`` rounds half to even, as ``jnp.round`` does, and every
step is the reference's f32 arithmetic in its order, so ``q``, the scale
and the new error are bit-equal to the reference's. The scales' mean sums
them in rank order (an all-gather, then one add after another), so that
it is the same on every rank and on every run. On a one-rank mesh the
exchange is the identity.
"""

from __future__ import annotations

import torch

from ..runtime import sharding as shd


def quantize(g: torch.Tensor):
    """Per-tensor symmetric int8: ``(q, scale)``, scale a 0-dim f32."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_update(g: torch.Tensor, error: torch.Tensor):
    """Error-feedback compression of one tensor: ``(q, scale,
    new_error)``."""
    corrected = g.to(torch.float32) + error
    q, scale = quantize(corrected)
    return q, scale, corrected - dequantize(q, scale)


def compressed_psum_mean(q: torch.Tensor, scale: torch.Tensor, mesh,
                         axis: str) -> torch.Tensor:
    """Mean over the ranks of ``axis`` of int8-quantized tensors: the
    int32 sum of ``q`` (one all-reduce), the scales' mean (one all-gather,
    summed in rank order), ``sum * mean_scale / n`` in f32."""
    n = shd.axis_sizes(mesh)[axis]
    total = shd.all_reduce(q.to(torch.int32), mesh, axis)
    scales = shd.all_gather(scale.reshape(1).to(torch.float32), mesh, axis)
    acc = scales[0]
    for i in range(1, n):
        acc = acc + scales[i]
    size = torch.tensor(float(n), dtype=torch.float32, device=q.device)
    return total.to(torch.float32) * (acc / size) / size


def make_compressed_grad_allreduce(mesh, axis: str = "data"):
    """``f(grads, errors) -> (mean_grads, new_errors)`` over dicts of
    tensors: each rank passes its own gradients (its microbatch's) and
    error state, and gets the compressed mean over ``axis`` and its new
    error."""

    def reduce(grads: dict, errors: dict):
        means, new_errors = {}, {}
        for name, g in grads.items():
            q, s, new_errors[name] = compress_update(g, errors[name])
            means[name] = compressed_psum_mean(q, s, mesh, axis)
        return means, new_errors

    return reduce


def init_error_state(params: dict) -> dict:
    """A zero f32 error for each tensor of ``params``."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
