"""C3O Hub Gateway API v1 — the canonical public surface.

One versioned, serializable request/response vocabulary for the paper's
whole collaborative loop (Fig. 4): discover a job (``SearchRequest``),
predict runtimes (``PredictRequest``), choose a cluster
(``ChooseRequest``), evaluate models (``ModelErrorsRequest``), and
contribute runtime data back with provenance (``ContributeRequest``).
The trust plane rides the same vocabulary: any request wraps in an
``AuthedRequest`` bearer-token envelope (mandatory on auth-enabled
gateways) and ``TrustStateRequest`` inspects a contributor's standing.
``HubGateway`` routes these across every published ``JobRepo``;
``repro_torch.api.codec`` gives every envelope a deterministic JSON form so the
same objects work in-process today and over HTTP later.
"""
from repro_torch.api.auth import TrustAuthority
from repro_torch.api.codec import decode, encode
from repro_torch.api.gateway import AsyncHubGateway, HubGateway
from repro_torch.api.types import (API_VERSION, AuthedRequest, ChooseRequest,
                                   ChooseResult, CompactRequest, CompactResult,
                                   ContributeRequest, ContributeResult,
                                   HealthResult, JobInfo, LaneSnapshot,
                                   ModelErrorsRequest, ModelErrorsResult,
                                   PredictRequest, PredictResult, Response,
                                   SearchRequest, SearchResult, StatsResult,
                                   TrustStateRequest, TrustStateResult)
from repro_torch.core.market import (ON_DEMAND, SPOT, MarketError, Placement,
                                     PriceBook)
from repro_torch.core.transfer import TransferPolicy

__all__ = [
    "API_VERSION", "AuthedRequest", "ChooseRequest", "ChooseResult",
    "CompactRequest", "CompactResult", "ContributeRequest",
    "ContributeResult", "HealthResult", "JobInfo", "LaneSnapshot",
    "ModelErrorsRequest", "ModelErrorsResult", "PredictRequest",
    "PredictResult", "Response", "SearchRequest", "SearchResult",
    "StatsResult", "TrustStateRequest", "TrustStateResult", "HubGateway",
    "AsyncHubGateway", "TrustAuthority", "TransferPolicy", "MarketError",
    "ON_DEMAND", "SPOT", "Placement", "PriceBook", "decode", "encode",
]
