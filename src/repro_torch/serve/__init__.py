"""Serving plane of the port: the graph-ranking service."""
from repro_torch.serve.graph_ranking import GraphRankingService, RankedNodes
