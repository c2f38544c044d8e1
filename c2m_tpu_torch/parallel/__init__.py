"""Data-parallel training over processes (``mesh.py``)."""
