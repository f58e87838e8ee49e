"""Graph substrate: CSR storage and synthetic generators (numpy only)."""
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.datasets import DATASETS, GraphDataset, get_dataset
from repro_torch.graph.generate import powerlaw_graph, sbm_graph

__all__ = ["CSRGraph", "powerlaw_graph", "sbm_graph", "get_dataset",
           "DATASETS", "GraphDataset"]
