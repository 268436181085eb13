"""Checkpoint storage for consistent regions: the port's own copy of
``repro.ckpt``, without JAX."""

from .store import CheckpointStore

__all__ = ["CheckpointStore"]
