"""Optimizers of the port: AdamW (``adamw``), the reference's update in
PyTorch."""
