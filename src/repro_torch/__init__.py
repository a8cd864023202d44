"""PyTorch + CUDA port of the historical k-core search system (``repro``).

Module for module beside the JAX package, which stays the reference: the
host build plane (``core``: temporal graphs, core times, ECB forests, the
k-stratified PECB index), the batched device query plane
(``core.batch_query``) whose fixpoint loop runs the hand-written CUDA
label-propagation kernel (``kernels``), the one-GPU executor
(``serving.executor``) and the serving entry point (``launch.serve``),
the persistent index store the serving registry writes through to and
promotes from (``store``) and tensor-tree checkpoints (``checkpoint``); and
for the model cells the dense LM (``models.transformer``, its projections
on the B5 GEMM kernel and its attention on the B6 flash-attention kernel)
and GraphSAGE (``models.gnn``, its aggregation on the B4 segment-sum
kernel, its projections on B5) with their configs, serve steps and train
steps (``configs``; every kernel's gradient is a kernel too), AdamW
(``optim``), the restarting step loop (``runtime``), the training CLI
(``launch.train``), the token stream and the GraphSAGE neighbour sampler
(``data``). Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
Imports torch, numpy and the standard library only.
"""
