"""GraphSAGE (mean aggregator) on the port's B4 and B5 kernels.

Counterpart of the GraphSAGE part of ``repro.models.gnn``
(``SAGEConfig``, ``sage_init``, ``sage_forward``, ``segment_mean``): the
same parameters under the same names, in f32, and the same arithmetic, so
the reference's weights carried over by
``core.carry.sage_params_from_reference`` give its logits. Where the
reference aggregates with ``jax.ops.segment_sum`` and projects with
``x @ w``, the port calls its kernels:

* every neighbour sum and degree count is ``ops.segment_sum`` (B4);
* every dense product (``w_self``, ``w_neigh``, the head) is
  ``ops.matmul`` (B5, its f32 path).

A batch is the reference's unified graph batch as tensors on one device:
``node_feat`` (n, d_in) f32, ``src`` and ``dst`` (E,) int32 and, for a
padded minibatch, ``edge_mask`` (E,) f32 (0.0 on the padding edges, which
the sampler points at node 0). The reference's other GNN families
(MeshGraphNet, NequIP, MACE) are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..kernels import ops


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


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


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


@torch.no_grad()
def init_params(cfg: SAGEConfig, generator: torch.Generator,
                device="cuda") -> GraphSAGE:
    """A model with the reference's initial distributions (``sage_init``):
    weights N(0, 1) / sqrt(fan-in), biases 0. Drawn from ``generator``,
    which lives on ``device``; the bits are not the reference's."""
    model = GraphSAGE(cfg, device)
    for name, p in model.named_parameters():
        if name.endswith(".b"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device).div_(p.shape[0] ** 0.5))
    return model


def segment_mean(vals: torch.Tensor, ids: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Mean of the rows of ``vals`` (E, d) per segment id, 0 for a segment
    with no row: two B4 calls, the sums and the counts."""
    s = ops.segment_sum(vals, ids, num)
    ones = torch.ones((vals.shape[0], 1), dtype=s.dtype, device=vals.device)
    return s / ops.segment_sum(ones, ids, num).clamp_min(1.0)


def sage_layer(layer: SAGELayer, x: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """One layer (``sage_forward``'s loop body): the mean of the in-edge
    neighbours' rows (masked edges counted out), both projections plus the
    bias, relu, and each row scaled to norm 1 (floored at 1e-6)."""
    n = x.shape[0]
    if mask is not None:
        msum = ops.segment_sum(x[src] * mask[:, None], dst, n)
        cnt = ops.segment_sum(mask[:, None], dst, n)
        agg = msum / cnt.clamp_min(1.0)
    else:
        agg = segment_mean(x[src], dst, n)
    x = ops.matmul(x, layer.w_self) + ops.matmul(agg, layer.w_neigh) + layer.b
    x = torch.relu(x)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-6)


@torch.inference_mode()
def sage_forward(model: GraphSAGE, batch: dict) -> torch.Tensor:
    """Logits (n, n_classes) in f32 of every node of ``batch``:
    ``2 * n_layers`` B4 calls and ``2 * n_layers + 1`` B5 calls."""
    src, dst = batch["src"], batch["dst"]
    mask = batch.get("edge_mask")
    x = batch["node_feat"]
    for layer in model.layers:
        x = sage_layer(layer, x, src, dst, mask)
    return ops.matmul(x, model.head)
