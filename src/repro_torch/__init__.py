"""PyTorch + CUDA port of the historical k-core search system (``repro``).

Module for module beside the JAX package, which stays the reference: the
host build plane (``core``: temporal graphs, core times, ECB forests, the
k-stratified PECB index), the batched device query plane
(``core.batch_query``) whose fixpoint loop runs the hand-written CUDA
label-propagation kernel (``kernels``), the one-GPU executor
(``serving.executor``) and the serving entry point (``launch.serve``); and
for the model cells the dense LM (``models.transformer``, its projections
on the B5 GEMM kernel and its attention on the B6 flash-attention kernel)
and GraphSAGE (``models.gnn``, its aggregation on the B4 segment-sum
kernel, its projections on B5) with their configs and serve steps
(``configs``) and the GraphSAGE neighbour sampler (``data``). Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
Imports torch, numpy and the standard library only.
"""
