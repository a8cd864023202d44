"""AdamW with a warmup + cosine schedule and global-norm clipping: the
port's copy of ``repro.optim.adamw``, in PyTorch.

The reference's update is the spec: the same arithmetic in the same order
(clip by the global norm, bias corrections, decoupled weight decay, the
update in f32 rounded to the parameter's dtype), with the moments kept in
f32 whatever the parameter's dtype. Two differences of form:

* parameters, gradients and moments are plain dicts of tensors keyed by
  name (a model's ``named_parameters()``), so the port's
  ``CheckpointManager`` saves the state as it is;
* the update is IN PLACE: the parameters and the moments are overwritten
  (the reference returns new arrays), so a step holds no second copy of
  them; per leaf it holds a few f32 temporaries of that leaf's size.

Nothing leaves the device: the step count, the learning rate and the
norm are 0-dim tensors beside the parameters.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as an
    f32 tensor: linear warmup over ``warmup_steps``, then a cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: dict[str, torch.Tensor]) -> dict:
    """``{"mu": {name: 0}, "nu": {name: 0}, "step": 0}``: f32 moments of
    each parameter's shape on its device, an int32 0-dim step."""
    first = next(iter(params.values()), None)
    device = first.device if first is not None else "cpu"
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return {"mu": zeros,
            "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict[str, torch.Tensor], specs: dict | None = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum over the leaves of the sum of their squares, in
    f32, the leaves added in order. With ``mesh``, each leaf is this
    rank's shard under ``specs[name]`` (a ``runtime.sharding.P``): its sum
    of squares is summed over the axes the leaf is split on and counted
    once over those it is replicated on, so the norm is the whole tree's
    on every rank (the unsharded one bit for bit on a one-rank mesh). One
    all-reduce per distinct set of split axes of more than one rank."""
    if not tree:
        return torch.zeros((), dtype=torch.float32)
    def squares(g):
        gf = g.to(torch.float32)
        return (gf * gf).sum()

    sums = torch.stack([squares(g) for g in tree.values()])
    if mesh is not None:
        from ..runtime import sharding as shd
        sizes = shd.axis_sizes(mesh)
        split = [tuple(a for a in shd.axis_names(mesh) if sizes[a] > 1
                       and any(a in shd._axes(part) for part in specs[n]))
                 for n in tree]
        for axes in dict.fromkeys(split):
            if not axes:
                continue
            idx = torch.tensor([i for i, s in enumerate(split) if s == axes],
                               device=sums.device)
            sums[idx] = shd.all_reduce(sums[idx], mesh, axes)
    total = sums[0]
    for i in range(1, len(sums)):
        total = total + sums[i]
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: dict,
                  specs: dict | None = None, mesh=None):
    """One AdamW step IN PLACE: every parameter and moment is overwritten,
    ``state["step"]`` advanced. Returns ``(params, state, {"grad_norm",
    "lr"})`` like the reference (the same ``params`` and ``state``
    dicts). On a ``mesh`` the parameters, gradients and moments are this
    rank's shards under ``specs`` (the moments share the parameters'
    specs, ``runtime.sharding.lm_opt_spec_tree``): the update is
    elementwise and stays local; only the norm spans the mesh
    (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step).to(gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads[name].to(torch.float32) * scale
        t = g * (1 - b1)
        mu.mul_(b1).add_(t)                          # b1 mu + (1 - b1) g
        torch.mul(g, 1 - b2, out=t)
        nu.mul_(b2).add_(t.mul_(g))                  # b2 nu + (1 - b2) g g
        del g
        denom = torch.div(nu, bc2, out=t).sqrt_().add_(cfg.eps)
        upd = (mu / bc1).div_(denom)                 # mhat / (sqrt(vhat) + eps)
        del t, denom
        p32 = p.to(torch.float32)
        upd.add_(p32 * cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p32.sub_(upd))                   # rounded to p's dtype
        del upd, p32
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
