"""One-GPU execution of the batched query plane."""
