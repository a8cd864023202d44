"""The all-to-all MoE dispatch (GShard / DeepSpeed-MoE style) over
explicit collectives: the port's ``repro.runtime.moe_a2a``.

Per rank, on its data-parallel shard of the tokens:

  1. token-parallel routing: the tokens are split over the TP axis too,
     and each rank routes its chunk (the router product on B5 in f32,
     pad experts' logits masked, ``transformer.route``'s stable top-k);
  2. a local capacity dispatch into an (E, C, d) buffer
     (``transformer.dispatch``, ``source_rows`` and ``repeated``: sorted,
     no atomics);
  3. one all-to-all over the TP group regroups the expert dimension: every
     rank receives the (E/tp, tp * C, d) slab of the experts it owns;
  4. the local experts' products: three B5 launches per local expert
     (``transformer.expert_rows`` on whole tensors);
  5. the all-to-all back, the combine in ascending expert order
     (``transformer.combine`` of ``token_slots``, no float atomics), the
     load-balance loss meaned over the DP and TP groups, and an
     all-gather of the TP chunks.

The capacity is the reference's for this path: ``C = max(1,
ceil(t_tp * K / E * capacity_factor))`` rounded up to a multiple of 8,
where ``moe_ffn`` rounds to 32. So at a binding capacity the two drop
different assignments, even on one rank (qwen2-moe's prefill: C = 344
against 352); with a capacity that does not bind they compute the same
outputs.

Requires E % tp == 0 (compose with ``MoEConfig.pad_experts``) and (B * S)
% (dp * tp) == 0. The arguments follow ``runtime.sharding.shard_map``: a
plain tensor is the global value, a DTensor its placed shards (so on a
model placed by ``sharding.shard_params`` on more than one rank, whose
parameters are local shards, ``transformer.moe_ffn`` refuses it); the result
is this rank's data-parallel shard of the output, ``(-1, S, d)``, the
whole output on a one-rank mesh. Gradients flow through the exchanges
(``sharding.all_to_all_tiled``, ``all_gather_tiled``, ``pmean``), and
the parameters' gradients are summed over the ranks that used them on
different tokens (``sharding.grad_sum``). The shared experts run outside
the exchange, on the rank's tokens, as the reference runs them outside
its ``shard_map``.
"""

from __future__ import annotations

import math
import types

import torch

from ..kernels import ops
from ..models import transformer as tfm
from . import sharding as shd


def a2a_capacity(mcfg: tfm.MoEConfig, t_tp: int) -> int:
    """Rows per expert of one rank's chunk of ``t_tp`` tokens: the
    reference's ``make_a2a_moe`` capacity, a multiple of 8."""
    C = max(1, math.ceil(t_tp * mcfg.top_k / mcfg.e_total
                         * mcfg.capacity_factor))
    return math.ceil(C / 8) * 8


def make_a2a_moe(mesh, dp, tp_axis: str = "model"):
    """``moe_fn(p, cfg, x) -> (out, aux)`` for
    ``transformer.set_moe_impl``: ``p`` a layer's ``MoE`` parameters, x
    (B, S, d)."""
    dp = shd._axes(dp)
    tp = shd.axis_sizes(mesh)[tp_axis]
    every = (tp_axis, *dp)

    def local_fn(router, wi, wg, wo, xt, mcfg):
        E, K = mcfg.e_total, mcfg.top_k
        if E % tp:
            raise ValueError(f"the a2a MoE needs E % tp == 0, got E {E} over "
                             f"{tp} ranks (set MoEConfig.pad_experts)")
        e_loc = E // tp
        t_dp, d = xt.shape
        if t_dp % tp:
            raise ValueError(f"{t_dp} tokens a data-parallel rank do not "
                             f"split over {tp} ranks")
        t_tp = t_dp // tp
        r = shd.axis_index(mesh, tp_axis)
        # 1. token-parallel routing of this rank's chunk
        xtl = shd.grad_sum(xt, mesh, tp_axis)[r * t_tp:(r + 1) * t_tp]
        logits = ops.matmul(xtl.float(), shd.grad_sum(router, mesh, every))
        if mcfg.pad_experts:
            pad = torch.arange(E, device=xt.device) >= mcfg.n_experts
            logits = logits.masked_fill(pad, -1e30)
        probs = torch.softmax(logits, dim=-1)
        eidx = tfm.route(probs, K)
        gate = probs.gather(-1, eidx)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        # 2. local capacity dispatch
        C = a2a_capacity(mcfg, t_tp)
        order, se, _, _, _, dest = tfm.dispatch(eidx, E, C)
        buf = tfm.repeated(xtl, K)[tfm.source_rows(order, dest, E * C,
                                                   t_tp * K)]  # (E * C, d)
        # 3. each rank its experts' slab: [sender][expert][row] ->
        # [expert][sender][row]
        slab = shd.all_to_all_tiled(buf, mesh, tp_axis)
        slab = slab.view(tp, e_loc, C, d).transpose(0, 1).reshape(
            e_loc * tp * C, d)
        # 4. the local experts' products (weights never move)
        w = types.SimpleNamespace(
            **{k: shd.grad_sum(v, mesh, dp) for k, v in
               (("wi", wi), ("wg", wg), ("wo", wo))})
        ho = tfm.expert_rows(w, slab.view(1, e_loc, tp * C, d), tfm.WHOLE,
                             (e_loc, tp * C))[:-1]
        # 5. back to the senders, then the combine
        ho = ho.view(e_loc, tp, C, d).transpose(0, 1).reshape(E * C, d)
        back = shd.all_to_all_tiled(ho, mesh, tp_axis)
        back = torch.cat([back, back.new_zeros(1, d)])
        outl = tfm.combine(back, eidx, gate,
                           tfm.token_slots(order, dest, t_tp, K))
        counts = torch.diff(tfm.starts_of(se, E),
                            append=se.new_tensor([t_tp * K]))
        aux = E * torch.sum(counts.float() / (t_tp * K) * probs.mean(dim=0))
        aux = shd.pmean(aux, mesh, every)
        # 6. the chunks gathered (replicated over tp again)
        return shd.all_gather_tiled(outl, mesh, tp_axis), aux

    def moe_fn(p, cfg, x):
        mcfg = cfg.moe
        B, S, d = x.shape
        xt = x.reshape(B * S, d)
        out, aux = shd.shard_map(
            lambda router, wi, wg, wo, xt: local_fn(router, wi, wg, wo, xt,
                                                     mcfg),
            mesh=mesh,
            in_specs=(shd.P(), shd.P(tp_axis, None, None),
                      shd.P(tp_axis, None, None), shd.P(tp_axis, None, None),
                      shd.P(dp, None)),
            out_specs=(shd.P(dp, None), shd.P()),
        )(p.router, p.wi, p.wg, p.wo, xt)
        if mcfg.n_shared:
            xs = shd.to_local(xt, mesh, shd.P(dp, None))
            shared = types.SimpleNamespace(
                **{k: shd.grad_sum(getattr(p, k), mesh, dp)
                   for k in ("shared_wi", "shared_wg", "shared_wo")})
            out = out + tfm.shared_experts(shared, mcfg, xs)
        return out.view(-1, S, d), aux

    return moe_fn
