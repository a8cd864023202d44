"""Input pipelines of the port: the GraphSAGE neighbour sampler
(``graph_sampler``) and the synthetic LM token stream (``lm_data``), numpy
copies of the reference's."""
