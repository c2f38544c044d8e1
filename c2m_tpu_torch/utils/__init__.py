"""Utilities of the port: the JAX <-> PyTorch weight bridge, checkpoints,
and the visual output (copies of ``c2m_tpu/utils``)."""
