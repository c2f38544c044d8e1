"""Data of the port: synthetic clips, the on-disk datasets and the loader
(copies of ``c2m_tpu/data``), without JAX."""
