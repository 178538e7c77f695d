"""Deterministic fault schedules (the port's own copy of the schedule half
of ``paddle_tpu/distributed/faults.py``).

A FaultSchedule maps (direction, frame index) to an action: explicit
frames first, then seeded random rates, else "pass".  Directions "c2s"
and "s2c" carry the wire actions of the RPC chaos proxy (``drop``,
``delay``, ``dup``, ``truncate``, ``corrupt``); the proxy itself
(``FaultyChannel``) and the transport it sits on are ROADMAP A8.  The
"fabric" direction carries the serving fabric's pool deaths:
serving/router.py consumes one fabric slot per router step, and
``pool_kill`` kills a pool's step loop (``pool_kill:<pid>`` names the
victim; a bare ``pool_kill`` lets the router pick one from
``delay_fraction(idx)``).  ``pool_proc_kill`` is the process-pool twin;
an in-process pool takes it as a cooperative kill.

A seeded schedule gives the reference's actions frame for frame: the
same ``random.Random`` draws in the same order under one lock, and the
same splitmix64 hash for ``delay_fraction``.
"""

import os
import random
import threading

__all__ = ["ACTIONS", "FaultSchedule"]

ACTIONS = ("pass", "drop", "delay", "dup", "truncate", "corrupt",
           "pool_kill", "pool_proc_kill")

# wire faults make no sense inside the fabric scheduler and vice versa
_FABRIC_ACTIONS = ("pass", "pool_kill", "pool_proc_kill")


def _valid_action(action):
    if action in ACTIONS:
        return True
    # explicit victim form: pool_kill:<pid> / pool_proc_kill:<pid>
    base, sep, arg = str(action).partition(":")
    return base in ("pool_kill", "pool_proc_kill") and sep and arg.isdigit()


class FaultSchedule:
    """Maps (direction, frame_index) -> action.

    Two layers, explicit first: ``schedule={"c2s": {3: "drop"}, "s2c":
    {...}}`` pins exact frames; anything unpinned falls through to the
    seeded random rates (``drop=0.1, dup=0.05, ...`` with ``seed``), and
    with no rates to "pass".  Frame indices count per direction from 0.

    ``seed=None`` resolves from the ``PADDLE_TPU_FAULT_SEED`` environment
    variable (falling back to 0), so a whole chaos run pins to one seed."""

    def __init__(self, schedule=None, seed=None, drop=0.0, delay=0.0,
                 dup=0.0, truncate=0.0, corrupt=0.0, pool_kill=0.0,
                 pool_proc_kill=0.0):
        if seed is None:
            seed = int(os.environ.get("PADDLE_TPU_FAULT_SEED", "0"))
        self._explicit = {"c2s": {}, "s2c": {}, "fabric": {}}
        for direction, frames in (schedule or {}).items():
            if direction not in self._explicit:
                raise ValueError("direction must be c2s|s2c|fabric, got %r"
                                 % direction)
            for idx, action in frames.items():
                if not _valid_action(action):
                    raise ValueError("unknown fault action %r" % action)
                is_fabric = str(action).partition(":")[0] in _FABRIC_ACTIONS
                if (direction == "fabric") != is_fabric and action != "pass":
                    raise ValueError(
                        "action %r is not valid on direction %r"
                        % (action, direction))
                self._explicit[direction][int(idx)] = action
        self._rates = (
            ("drop", float(drop)), ("delay", float(delay)),
            ("dup", float(dup)), ("truncate", float(truncate)),
            ("corrupt", float(corrupt)),
        )
        self._fabric_rates = (("pool_kill", float(pool_kill)),
                              ("pool_proc_kill", float(pool_proc_kill)))
        self._seed = int(seed)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._counters = {"c2s": 0, "s2c": 0, "fabric": 0}

    def delay_fraction(self, idx):
        """Deterministic per-frame fraction in (0, 1]: a splitmix64-style
        hash of (seed, frame index), a pure function of the schedule
        (never a shared-rng draw that would depend on thread order)."""
        z = ((self._seed & 0xFFFFFFFFFFFFFFFF) << 32 | (idx & 0xFFFFFFFF))
        z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
        return ((z & 0xFFFFFF) + 1) / float(1 << 24)

    def next_action(self, direction):
        """Consume one frame slot in `direction`; return (index, action)."""
        with self._lock:
            idx = self._counters[direction]
            self._counters[direction] += 1
            action = self._explicit[direction].get(idx)
            if action is not None:
                return idx, action
            # seeded draws happen in one global order (under the lock), so
            # a fixed seed gives a reproducible fault sequence
            roll = self._rng.random()
            acc = 0.0
            rates = (self._fabric_rates if direction == "fabric"
                     else self._rates)
            for name, rate in rates:
                acc += rate
                if roll < acc:
                    return idx, name
            return idx, "pass"
