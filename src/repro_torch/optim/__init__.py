"""Optimizer configuration (the optimizer itself waits for the training
port)."""
from repro_torch.optim.adam import AdamConfig

__all__ = ["AdamConfig"]
