"""Serving in the port: the PPR engine core (``ppr_engine.py``) and the
LM decode engine (``engine.py``).  The PPR serving runtime, load generator
and metrics come with a later slice."""
from repro_torch.serving.engine import Request, ServingEngine, greedy_sample, make_serve_step
from repro_torch.serving.ppr_engine import (
    PPREngine,
    PPRQuery,
    PPRResponse,
    make_query_stream,
)

__all__ = ["PPREngine", "PPRQuery", "PPRResponse", "make_query_stream",
           "Request", "ServingEngine", "greedy_sample", "make_serve_step"]
