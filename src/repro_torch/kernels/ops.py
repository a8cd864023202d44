"""The port's kernel surface, mirroring ``repro.kernels.ops``.

Every function here dispatches on the device of its tensors: the
hand-written Hopper kernel for CUDA tensors, the plain PyTorch version
(``ref.py``) for CPU tensors. There is no switch that routes CUDA tensors
to the plain version. The TPU kernels not yet ported are listed in
ROADMAP.md (queue B).
"""

from .label_prop import label_prop_round

__all__ = ["label_prop_round"]
