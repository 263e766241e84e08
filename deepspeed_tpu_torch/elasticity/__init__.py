"""Logical shardings of a checkpoint (``logical.py``); elastic resize and
the rest of the JAX package's ``elasticity/`` are ROADMAP.md row A12."""
