"""Input pipelines of the port: the GraphSAGE neighbour sampler
(``graph_sampler``), the synthetic LM token stream (``lm_data``) and
MIND's user histories (``recsys_data``), numpy copies of the
reference's."""
