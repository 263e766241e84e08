"""Offline checkpoint tooling: Megatron-LM TP×PP-merge loading
(``megatron.py``). Further resharding is the universal load of
``runtime/checkpointing.py``."""

from .megatron import load_megatron_checkpoint  # noqa: F401
