"""The port's models: the decoder-only LMs, dense and MoE
(``transformer``), whose projections and attention run on the port's B5
and B6 kernels; the GNNs (``gnn``, with ``equivariant``), whose
aggregations run on B4 and their projections on B5; and MIND
(``recsys``), whose item-table lookups have B4 for their gradient and
whose products run on B5."""
