"""Atomic, async checkpoints in the JAX package's layout (port of
``repro/checkpoint``)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
