"""The port's checkpointer (``repro.checkpoint``) over flat dicts of tensors."""
from .checkpointer import Checkpointer, CheckpointMeta

__all__ = ["Checkpointer", "CheckpointMeta"]
