"""Serving plane of the port: the graph-ranking service and the
serve-while-ingest streaming similarity service with its continuous
micro-batching request frontend."""
from repro_torch.serve.graph_ranking import GraphRankingService, RankedNodes
from repro_torch.serve.frontend import (
    FrontendConfig,
    IntensityModel,
    QueueFullError,
    RequestFrontend,
)
from repro_torch.serve.streaming import (
    AdmissionError,
    CompactionPolicy,
    ServiceGuardrails,
    StreamingSimilarityService,
)
