"""User-facing Executor (the counterpart of ``paddle_tpu/executor.py``).

``Executor(place).run(program, feed={...}, fetch_list=[...], scope,
return_numpy)`` keeps the reference's contract.  Feeds go onto the
executor's device, the block runs eagerly through the PyTorch
lowerings (``core/trace.py``), updated persistables go back into the
scope, and fetches come back as numpy arrays.

There is no jit here, so no compile: what the executor memoizes per
(program version, feed names, fetch names, scope) is the run plan
(DCE mask and state split).  ``compile_count`` counts those plans, so
the serving engine's contract that occupancy churn never re-plans its
step reads the same way it does in the reference.
"""

import numpy as np
import torch

from . import framework
from .core import scope as scope_mod
from .core.registry import LowerCtx, fold_seed
from .core.trace import build_plan, run_block
from .places import default_place
from .profiler import RecordEvent

__all__ = ["Executor", "global_scope", "scope_guard"]

global_scope = scope_mod.global_scope
scope_guard = scope_mod.scope_guard

_KIND = {"f": "f", "i": "i", "u": "i", "b": "b"}


def _kind(dtype_str):
    if dtype_str == "bfloat16":
        return "f"
    return _KIND.get(np.dtype(dtype_str).kind, "?")


def as_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        self._plans = {}
        self._step = 0
        self._plans_built = 0

    @property
    def compile_count(self):
        """How many run plans this executor has built."""
        return self._plans_built

    def _to_device(self, name, value, program):
        """One feed onto the device, with the reference's kind-level
        dtype guard (int vs float vs bool; widths may differ).  numpy
        feeds are copied, never aliased: a lowering that updates in
        place must not reach back into the caller's array."""
        if isinstance(value, torch.Tensor):
            t = value.to(self.device)
        else:
            arr = np.asarray(value)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)  # the reference's f32 policy
            t = torch.tensor(arr, device=self.device)
        var = program.global_block()._find_var_recursive(name)
        if var is not None and var.dtype:
            want, got = _kind(var.dtype), _kind(str(t.dtype).replace("torch.", ""))
            if want != got:
                raise TypeError(
                    "feed '%s' has dtype %s but the program declares %s — "
                    "cast the feed or fix the data layer dtype"
                    % (name, t.dtype, var.dtype))
        return t

    def _commit_state(self, plan, scope):
        """State that is not yet a tensor on this device (numpy from a
        checkpoint, a tensor from another device) moves once and is
        written back, so read-only weights are not re-uploaded."""
        for n in plan.state_names:
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor):
                if v.device != self.device:
                    scope.set(n, v.to(self.device))
            else:
                scope.set(n, torch.as_tensor(np.asarray(v),
                                             device=self.device))

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, framework.Variable) else str(v)
                       for v in (fetch_list or [])]
        with RecordEvent("feed_upload", cat="feed"):
            feeds = {n: self._to_device(n, v, program)
                     for n, v in feed.items()}
        key = (id(program), program._version, tuple(sorted(feeds)),
               tuple(fetch_names), id(scope))
        entry = self._plans.get(key)
        if entry is None or entry[0] is not program:
            entry = (program, build_plan(program, 0, list(feeds), fetch_names,
                                         scope))
            self._plans[key] = entry
            self._plans_built += 1
        plan = entry[1]
        self._commit_state(plan, scope)
        ctx = LowerCtx(seed=fold_seed(program.random_seed or 90157,
                                      self._step),
                       device=self.device)
        self._step += 1
        with RecordEvent("executor_run"), torch.no_grad():
            fetches = run_block(program, plan, feeds, scope, ctx)
        if return_numpy:
            return [as_numpy(t) for t in fetches]
        return fetches
