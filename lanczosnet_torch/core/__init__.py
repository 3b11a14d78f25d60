"""The padded, masked graph-batch contract."""

from lanczosnet_torch.core.graph_batch import GraphBatch, batch_graphs, pad_graph

__all__ = ["GraphBatch", "batch_graphs", "pad_graph"]
