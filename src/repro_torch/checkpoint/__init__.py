from .checkpointer import CheckpointManager, Checkpointer

__all__ = ["Checkpointer", "CheckpointManager"]
