"""Continuous-batching serving (the counterpart of ``paddle_tpu/serving``)."""

from .engine import ServingEngine, serve_one_at_a_time
from .pool import SlotPool
from .trace import Request, make_poisson_trace

__all__ = ["ServingEngine", "serve_one_at_a_time", "SlotPool", "Request",
           "make_poisson_trace"]
