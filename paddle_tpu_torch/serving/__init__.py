"""Continuous-batching serving (the counterpart of ``paddle_tpu/serving``):
the engine, its slot pool and prefix cache, the traces, and the
in-process serving fabric (router.FabricRouter)."""

from .engine import ServingEngine, serve_one_at_a_time
from .pool import SlotPool
from .prefix import PrefixCache
from .router import FabricRouter, parse_pool_schedule
from .trace import Request, make_poisson_trace, make_prefix_trace

__all__ = ["ServingEngine", "serve_one_at_a_time", "SlotPool", "PrefixCache",
           "FabricRouter", "parse_pool_schedule", "Request",
           "make_poisson_trace", "make_prefix_trace"]
