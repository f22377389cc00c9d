"""Batch sharding over devices (mesh.py) and processes (distributed.py)."""
