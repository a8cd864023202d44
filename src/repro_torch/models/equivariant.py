"""Cartesian-irrep E(3)-equivariant building blocks (l_max = 2), the
port's ``repro.models.equivariant``.

Features are carried as Cartesian irreps, as the reference carries them:

    scalars  s  : (n, C)
    vectors  V  : (n, C, 3)
    2-tensors T : (n, C, 3, 3)   (traceless symmetric <=> l = 2)

and every coupling is a dot, outer or matrix product, exactly equivariant
under O(3) rotations (parity-odd cross-product paths omitted, as in the
reference). These are small dense contractions with no parameter: the
reference computes them in ``jnp.einsum`` outside any Pallas kernel, and
so they stay plain PyTorch here, on whatever device their tensors lie.
Every function is twice differentiable (NequIP's and MACE's force losses
differentiate a gradient through them), ``edge_basis`` and ``bessel_rbf``
at r = 0 too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: paths per output irrep
N_PATHS = 3


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def traceless_sym(M: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto traceless-symmetric (the l = 2 irrep)."""
    Ms = 0.5 * (M + M.transpose(-1, -2))
    tr = Ms.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return Ms - tr * _eye3(M) / 3.0


def edge_basis(rvec: torch.Tensor, eps: float = 1e-6):
    """``(d, rhat, Y2)`` of edge vectors (E, 3): the length (E,), the unit
    vector (E, 3) and the l = 2 Cartesian basis (E, 3, 3). The length is
    ``sqrt(|r|^2 + eps^2)``, so a zero-length edge (a padding edge at node
    0) gets rhat = 0 and finite derivatives of every order, not NaN."""
    d2 = (rvec * rvec).sum(-1, keepdim=True)
    d = torch.sqrt(d2 + eps * eps)
    rhat = rvec / d
    Y2 = rhat[..., :, None] * rhat[..., None, :] - _eye3(rvec) / 3.0
    return d[..., 0], rhat, Y2


def bessel_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis (..., n_rbf) with the smooth polynomial cutoff
    of order 6 (NequIP eq. 8), d floored at 1e-9 and d / cutoff clipped to
    [0, 1] as the reference does."""
    d = torch.clamp_min(d, 1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    basis = (math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d[..., None]
                                                 / cutoff) / d[..., None])
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    p = 6
    env = (1.0 - ((p + 1) * (p + 2) / 2) * x**p + p * (p + 2) * x**(p + 1)
           - (p * (p + 1) / 2) * x**(p + 2))
    return basis * env[..., None]


# -- tensor-product paths (all O(3)-equivariant, parity-even) -------------
# Each maps (edge-gathered sender irreps, edge basis) to messages.

def tp_to_scalar(s, V, T, rhat, Y2) -> torch.Tensor:
    """Paths landing in the scalar irrep: (E, C, 3 paths)."""
    p1 = torch.einsum("eci,ei->ec", V, rhat)
    p2 = torch.einsum("ecij,eij->ec", T, Y2)
    return torch.stack([s, p1, p2], dim=-1)


def tp_to_vector(s, V, T, rhat, Y2) -> torch.Tensor:
    """Paths landing in the vector irrep: (E, C, 3, 3 paths)."""
    p0 = s[..., None] * rhat[:, None, :]
    p2 = torch.einsum("ecij,ej->eci", T, rhat)
    return torch.stack([p0, V, p2], dim=-1)


def tp_to_tensor(s, V, T, rhat, Y2) -> torch.Tensor:
    """Paths landing in the l = 2 irrep: (E, C, 3, 3, 3 paths)."""
    p0 = s[..., None, None] * Y2[:, None]
    p1 = traceless_sym(V[..., :, None] * rhat[:, None, None, :])
    return torch.stack([p0, p1, T], dim=-1)


def gated_nonlin(s, V, T, gates):
    """Equivariant nonlinearity: silu on the scalars, sigmoid gates on V
    and T. ``gates`` (n, 2C): one gate per V channel, then one per T
    channel."""
    C = s.shape[-1]
    gV = torch.sigmoid(gates[..., :C])
    gT = torch.sigmoid(gates[..., C:])
    return F.silu(s), V * gV[..., None], T * gT[..., None, None]


# -- correlation products (MACE A->B basis, orders 2 and 3) ----------------

def correlation_products(s, V, T):
    """Pairwise (order-2) equivariant products of a feature set with
    itself: extra (scalars (n, 3C), vectors (n, 2C, 3), tensors (n, 2C,
    3, 3)) channel blocks."""
    s2 = s * s
    vv = torch.einsum("nci,nci->nc", V, V)
    tt = torch.einsum("ncij,ncij->nc", T, T)
    sV = s[..., None] * V
    tV = torch.einsum("ncij,ncj->nci", T, V)
    sT = s[..., None, None] * T
    vvT = traceless_sym(V[..., :, None] * V[..., None, :])
    return (torch.cat([s2, vv, tt], dim=-1),
            torch.cat([sV, tV], dim=-2),
            torch.cat([sT, vvT], dim=-3))
