"""Program analyses (the counterpart of ``paddle_tpu/analysis``), limited
to the def-use helpers (``graph.py``); the verifier is ROADMAP A9."""

from .graph import (consumer_count, consumer_map, consumer_ops,
                    def_use_lists, producer_map, producer_ops)

__all__ = ["consumer_count", "consumer_map", "consumer_ops",
           "def_use_lists", "producer_map", "producer_ops"]
