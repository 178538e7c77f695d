"""User-facing Executor (the counterpart of ``paddle_tpu/executor.py``).

``Executor(place).run(program, feed={...}, fetch_list=[...],
feed_var_name, fetch_var_name, scope, return_numpy, use_program_cache)``
keeps the reference's contract and order.  Feeds go onto the
executor's device, the block runs eagerly through the PyTorch
lowerings (``core/trace.py``), updated persistables go back into the
scope, and fetches come back as numpy arrays.

There is no jit here, so no compile: what the executor memoizes per
(program version, feed names, fetch names, scope) is the run plan
(DCE mask and state split).  ``compile_count`` counts those plans, so
the serving engine's contract that occupancy churn never re-plans its
step reads the same way it does in the reference.

A program stamped by ``parallel.annotate_spmd`` runs as this rank's
shard of the job (the reference's ``_run_spmd`` runs one program over
the whole mesh): every persistable the rule table shards is held in the
scope as this rank's slab, cut once from the full value at the first
run that reads it; the op lowerings see the mesh through
``spmd_lowering``; and a fetch of a sharded var returns the full value,
gathered over its axis, as the reference's global arrays do.  Ported:
the vocab-sharded projection of ``fused_linear_xent`` on a ``dp`` axis
of size 1.  A ``dp`` axis of size > 1, or a table sharding any other
persistable over an axis of size > 1, raises (ROADMAP A7); an axis of
size 1 shards nothing, so on such a mesh a stamped program runs exactly
as the unstamped one.
"""

import contextlib

import numpy as np
import torch

from . import framework
from .core import scope as scope_mod
from .core.registry import LowerCtx, fold_seed
from .core.trace import build_plan, run_block
from .parallel import collective
from .parallel.partition_rules import spmd_lowering
from .places import default_place
from .profiler import RecordEvent

__all__ = ["Executor", "global_scope", "scope_guard", "gather_persistable"]

global_scope = scope_mod.global_scope
scope_guard = scope_mod.scope_guard

_KIND = {"f": "f", "i": "i", "u": "i", "b": "b"}


def _kind(dtype_str):
    if dtype_str == "bfloat16":
        return "f"
    return _KIND.get(np.dtype(dtype_str).kind, "?")


def as_numpy(t):
    """Fetch result -> numpy; lists and tuples map element by element, as
    the reference's as_numpy does."""
    if isinstance(t, (list, tuple)):
        return [as_numpy(v) for v in t]
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _declared_shape(program, name):
    var = program.global_block()._find_var_recursive(name)
    if var is None or var.shape is None:
        return None
    shape = tuple(int(d) for d in var.shape)
    return shape if all(d >= 0 for d in shape) else None


def _slab_of(program, name):
    """(mesh, LocalSlice) of `name` under the program's stamp, or None
    when the program is unstamped or the var is held whole."""
    spmd = getattr(program, "_spmd", None)
    shape = _declared_shape(program, name)
    if spmd is None or shape is None:
        return None
    mesh, rules = spmd["mesh"], spmd["rules"]
    if rules.match(name)[0] is None:
        return None
    sl = rules.sharding_for(mesh, name, shape)
    return (mesh, sl) if sl is not None else None


def _gather(value, mesh, sl):
    """The full value of a slab (a collective over the slab's axis: every
    rank of it calls this); anything else as it is."""
    if tuple(value.shape) != sl.shape:
        return value
    return collective.all_gather(value, mesh.group(sl.axis), dim=sl.dim)


def gather_persistable(scope, program, name):
    """The full value of persistable `name` of a stamped `program`,
    gathered from the ranks' slabs where the scope holds a slab (every
    rank of the job calls it), else the scope's value."""
    value = scope.find_var(name)
    found = _slab_of(program, name)
    return value if found is None else _gather(value, *found)


def _vocab_projections(block):
    """Names of the weights fed untransposed to fused_linear_xent: the
    only persistables the port holds as vocab slabs."""
    return {op.inputs["W"][0] for op in block.ops
            if op.type == "fused_linear_xent"
            and not op.attrs.get("transpose_w", False)}


def _spmd_layout(program, plan):
    """The stamped program's slabs among the plan's state, as [(name,
    LocalSlice)], and its fetches' as [(index, LocalSlice)]; raises for
    what the port does not shard yet."""
    spmd = program._spmd
    mesh, rules = spmd["mesh"], spmd["rules"]
    dp_axis = getattr(rules, "dp_axis", None)
    if dp_axis and mesh.size(dp_axis) > 1:
        raise NotImplementedError(
            "a %s axis of size %d (data parallelism: the gradient "
            "all-reduce and the global-batch loss) is not ported yet "
            "(ROADMAP A7)" % (dp_axis, mesh.size(dp_axis)))
    block = program.global_block()
    vocab = _vocab_projections(block)
    base = getattr(rules, "base_name", lambda n: n)
    slabs = []
    for name in plan.state_names:
        var = block._find_var_recursive(name)
        found = _slab_of(program, name) if var is not None and \
            var.persistable else None
        if found is None:
            continue
        sl = found[1]
        if base(name) not in vocab or sl.dim != 1:
            raise NotImplementedError(
                "%s: the rule table splits dim %d over %s = %d; the port "
                "shards only the vocab projection of fused_linear_xent so "
                "far (tensor-parallel trunks, sharded embeddings: ROADMAP "
                "A7)" % (name, sl.dim, sl.axis, mesh.size(sl.axis)))
        slabs.append((name, sl))
    fetches = [(i, found[1]) for i, n in enumerate(plan.fetch_names)
               for found in [_slab_of(program, n)] if found is not None]
    return mesh, rules, slabs, fetches


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

    @staticmethod
    def _place_slabs(slabs, scope):
        """Replace each sharded persistable that the scope holds whole by
        this rank's slab (narrowed, then contiguous).  A value already
        of the slab's shape was placed by an earlier run."""
        for name, sl in slabs:
            v = scope.find_var(name)
            shape = tuple(v.shape)
            if shape == sl.full_shape:
                scope.set(name, v.narrow(sl.dim, sl.start,
                                         sl.size).contiguous())
            elif shape != sl.shape:
                raise ValueError(
                    "%s: the scope holds %s, neither the whole var %s nor "
                    "this rank's slab %s" % (name, shape, sl.full_shape,
                                             sl.shape))

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """The reference's signature and order.  feed_var_name,
        fetch_var_name and use_program_cache change nothing here: feeds
        and fetches go by name, and plans are always cached per (program
        version, feeds, fetches, scope)."""
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
            plan = build_plan(program, 0, list(feeds), fetch_names, scope)
            layout = (_spmd_layout(program, plan)
                      if getattr(program, "_spmd", None) else None)
            entry = (program, plan, layout)
            self._plans[key] = entry
            self._plans_built += 1
        _, plan, layout = entry
        self._commit_state(plan, scope)
        lowering = contextlib.nullcontext()
        if layout is not None:
            mesh, rules, slabs, fetch_slabs = layout
            self._place_slabs(slabs, scope)
            lowering = spmd_lowering(mesh, rules)
        ctx = LowerCtx(seed=fold_seed(program.random_seed or 90157,
                                      self._step),
                       device=self.device)
        self._step += 1
        with RecordEvent("executor_run"), torch.no_grad(), lowering:
            fetches = run_block(program, plan, feeds, scope, ctx)
            if layout is not None:
                for i, sl in fetch_slabs:
                    fetches[i] = _gather(fetches[i], mesh, sl)
        if return_numpy:
            return [as_numpy(t) for t in fetches]
        return fetches
