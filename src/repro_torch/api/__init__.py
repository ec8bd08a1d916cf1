# Suggestion-service API (v1) of the port: the typed suggest/observe/report
# boundary between trial execution and the optimizer + system-of-record
# store, in process (LocalClient) or over HTTP (serve_api, HTTPClient).
# See API.md.
from repro_torch.api.client import SuggestionClient
from repro_torch.api.http import ApiServer, HTTPClient, serve_api
from repro_torch.api.local import LocalClient
from repro_torch.api.protocol import (DECISION_CONTINUE, DECISION_PAUSE,
                                      DECISION_STOP, ApiError, BestRequest,
                                      BestResponse, CreateExperiment,
                                      CreateResponse, Decision, ObserveRequest,
                                      ObserveResponse, PROTOCOL_VERSION,
                                      ReleaseRequest, ReleaseResponse,
                                      ReportRequest, StatusRequest,
                                      StatusResponse, StopRequest,
                                      SuggestBatch, Suggestion, SuggestRequest)

__all__ = ["SuggestionClient", "LocalClient", "HTTPClient", "ApiServer",
           "serve_api", "ApiError", "PROTOCOL_VERSION", "CreateExperiment",
           "CreateResponse", "Suggestion", "SuggestRequest", "SuggestBatch",
           "ObserveRequest", "ObserveResponse", "ReportRequest", "Decision",
           "DECISION_CONTINUE", "DECISION_STOP", "DECISION_PAUSE",
           "ReleaseRequest", "ReleaseResponse", "StatusRequest",
           "StatusResponse", "StopRequest", "BestRequest", "BestResponse"]
