"""Sharding of the flush's G1 MSMs over a mesh of devices (``mesh.py``)."""
