"""Serving plane of the port: the graph-ranking service, the approximate
top-k head, the serve-while-ingest streaming similarity service with its
continuous micro-batching request frontend, and the LM serving engine."""
from repro_torch.serve.engine import GenerationResult, ServingEngine
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
from repro_torch.serve.topk_head import ApproxTopKHead, TopKHeadConfig
