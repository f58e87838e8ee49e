"""Training runtime: the GNN trainer shim over the engine (port of
``repro.train``)."""
from repro_torch.train.trainer import GNNTrainer, TrainReport

__all__ = ["GNNTrainer", "TrainReport"]
