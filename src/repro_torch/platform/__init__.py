"""The port's side of the streaming platform: the trainer PE's loop, which
runs the port's training step inside a streams job.  The control plane
(controllers, fabric, transport) does no model compute and stays in the
JAX package; ``run_trainer`` works against a PE runtime by duck typing."""

from .trainer import run_trainer

__all__ = ["run_trainer"]
