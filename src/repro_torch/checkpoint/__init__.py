"""Checkpoint / restart of the training state."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer, latest_step, restore, save)
