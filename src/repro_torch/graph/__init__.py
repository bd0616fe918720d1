"""Graph substrate: CSR/ELL structures, generators, partitioning."""
from repro_torch.graph.csr import Graph, build_graph, to_ell, symmetrize_edges
from repro_torch.graph.partition import PartitionedGraph, partition_graph

__all__ = [
    "Graph",
    "build_graph",
    "to_ell",
    "symmetrize_edges",
    "PartitionedGraph",
    "partition_graph",
]
