"""Input pipelines of the port: the GraphSAGE neighbour sampler
(``graph_sampler``), a numpy copy of the reference's."""
