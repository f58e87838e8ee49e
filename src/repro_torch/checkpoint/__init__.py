"""Checkpoints: atomic, keep-N, in the reference's format (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_aux, load_checkpoint,
                                          save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "load_aux", "latest_step"]
