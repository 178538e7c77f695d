"""Profiler spans (the counterpart of ``paddle_tpu/profiler.py``).

``RecordEvent`` marks a host span as a ``torch.profiler`` user range, so
a ``torch.profiler.profile(activities=[CPU, CUDA])`` trace shows the
serving engine's admit / step / sample phases beside the device
kernels they launched.  Outside a profiler session the span costs one
no-op context enter and exit.
"""

import torch

__all__ = ["RecordEvent"]


class RecordEvent:
    """RAII span.  `cat` names the span's phase; it is kept in the
    range name so a trace groups spans by phase."""

    def __init__(self, name, cat=None):
        self.name = name if cat is None else "%s:%s" % (name, cat)
        self._rf = None

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False
