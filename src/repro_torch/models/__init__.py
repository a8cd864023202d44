"""The port's models: the dense decoder-only LM (``transformer``), whose
projections and attention run on the port's B5 and B6 kernels."""
