"""Serving in the port: the PPR engine (``ppr_engine.py``), its serving
runtime with the admission queue and the invalidating result cache
(``runtime.py``), the closed-loop load generator (``loadgen.py``) and the
metrics bag (``metrics.py``); and the LM decode engine (``engine.py``)."""
from repro_torch.serving.engine import Request, ServingEngine, greedy_sample, make_serve_step
from repro_torch.serving.loadgen import (
    LoadConfig,
    LoadReport,
    VirtualClock,
    make_workload,
    run_closed_loop,
    zipf_weights,
)
from repro_torch.serving.metrics import Gauge, ServingMetrics, StageTimer
from repro_torch.serving.ppr_engine import (
    PPREngine,
    PPRQuery,
    PPRResponse,
    make_query_stream,
)
from repro_torch.serving.runtime import Admission, QueueEntry, ServingRuntime

__all__ = ["PPREngine", "PPRQuery", "PPRResponse", "make_query_stream",
           "Admission", "QueueEntry", "ServingRuntime",
           "LoadConfig", "LoadReport", "VirtualClock", "make_workload",
           "run_closed_loop", "zipf_weights",
           "Gauge", "ServingMetrics", "StageTimer",
           "Request", "ServingEngine", "greedy_sample", "make_serve_step"]
