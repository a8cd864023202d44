"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its hand-written kernel is
held to: the CPU tests run these against the JAX reference, and
``chip_smoke.py`` compares each kernel with its plain version on the card.
A wrapper calls the plain version only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch


def label_prop_round(labels: torch.Tensor, link_l: torch.Tensor,
                     link_r: torch.Tensor, link_p: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """One min-label round over batched forest links (B, N) + jump.

    Counterpart of ``repro.kernels.ref.label_prop_round``: a link counts
    iff it is >= 0 and both of its ends are active, else it offers the
    sentinel ``N``; the pointer jump reads the PRE-round labels. int32
    labels and links, bool ``active``; returns int32 (B, N)."""
    B, N = labels.shape

    def nb(link):
        ok = (link >= 0) & active
        linkc = link.clamp(0, N - 1).long()
        lab = torch.gather(labels, 1, linkc)
        act = torch.gather(active, 1, linkc)
        return torch.where(ok & act, lab, N)

    new = torch.minimum(labels, torch.minimum(
        nb(link_l), torch.minimum(nb(link_r), nb(link_p))))
    jumped = torch.where(new < N,
                         torch.gather(labels, 1, new.clamp(0, N - 1).long()),
                         new)
    return torch.minimum(new, jumped)
