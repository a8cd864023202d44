"""The port's kernel surface, mirroring ``repro.kernels.ops``.

Every function here dispatches on the device of its tensors: the
hand-written Hopper kernel for CUDA tensors, the plain PyTorch version
(``ref.py``) for CPU tensors. There is no switch that routes CUDA tensors
to the plain version. Every TPU kernel of the reference has its
counterpart here (ROADMAP.md, queue B).
"""

import torch

from .flash_attention import flash_attention
from .kcore_peel import degree_count, kcore_fixpoint, peel_round
from .label_prop import label_prop_round
from .segment_matmul import matmul, segment_sum
from .segmented_select import kth_smallest, segmented_count_le

__all__ = ["degree_count", "flash_attention", "kcore_fixpoint",
           "kcore_peel_round", "kth_smallest", "label_prop_round", "matmul",
           "segment_sum", "segmented_count_le"]


def kcore_peel_round(src, dst, alive, n: int, k: int):
    """One peel round (B3a then B3b): ``(new_alive, changed)``, with
    ``changed`` a 0-dim bool tensor on the edges' device (no host read)."""
    changed = torch.zeros(1, dtype=torch.int32, device=src.device)
    new_alive = peel_round(src, dst, alive, n, k, changed=changed)
    return new_alive, changed[0] != 0
