"""PPR serving in the port: the continuous-batching engine core
(``ppr_engine.py``).  The serving runtime, load generator and metrics come
with a later slice."""
from repro_torch.serving.ppr_engine import (
    PPREngine,
    PPRQuery,
    PPRResponse,
    make_query_stream,
)

__all__ = ["PPREngine", "PPRQuery", "PPRResponse", "make_query_stream"]
