"""Distributed runtime (the counterpart of ``paddle_tpu/distributed``).

Ported so far: ``faults.FaultSchedule``, the seeded fault schedule whose
``fabric`` direction drives the serving fabric's pool-kill chaos
(``serving/router.py``).  The schedule's wire actions are validated as
the reference validates them, but nothing consumes them yet: the RPC
transport, ``FaultyChannel`` and ``_recv_frame``, the parameter server
and the launcher are ROADMAP A8.
"""

from .faults import ACTIONS, FaultSchedule

__all__ = ["ACTIONS", "FaultSchedule"]
