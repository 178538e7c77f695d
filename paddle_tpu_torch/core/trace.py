"""Block runner (the counterpart of ``paddle_tpu/core/trace.py``).

The reference traces a block's ops into one jitted XLA function.  Here
the block runs op by op through the PyTorch lowerings, on tensors that
already live on the executor's device.  ``run_step`` is that op loop as
a function of (feeds, state tensors) to (fetches, updated-state
tensors), with no scope inside, as the reference's
``build_traced_function`` is: ``core/graph.py`` runs it between the
scope's reads and writes, and captures it as a CUDA graph.  What
carries over unchanged:

- the DCE mask (``dce_mask``): ops reachable from the fetches, plus
  every op writing persistable state, run; the rest are skipped;
- the state split: the block reads scope state it does not produce,
  and every persistable it writes is returned for the scope (the
  reference threads these as donated outputs).

A run's plan (keep mask, state reads, persistable writes) depends only
on the program version, the feed and fetch names and the scope, so the
executor memoizes it; ``RunPlan`` is that memo.

``<type>_grad`` ops built by ``backward.py`` run through the generic
``lower_grad_op`` (the vjp of the forward rule).  An op that overwrites
its own inputs (the lr schedule's ``increment``, Adam's in-place
updates) leaves env holding its outputs under the input names; where a
grad op re-runs such an op's forward rule, the runner keeps the op's
inputs as they were before it ran (the reference's input snapshots).
Only ops a kept grad op refers to are snapshotted, so Adam's in-place
updates keep no second copy of the parameters.  Each grad op runs inside
an ``op_grad:<forward type>`` profiler span, so a trace splits the
backward's host time by op type.

A SelectedRows value (``core/selected_rows.py``, the sparse embedding
gradient) reaches only the ops registered with
``handles_selected_rows``; every other op, and every fetch and updated
var, gets it densified, as the reference's tracer does.
"""

from ..profiler import RecordEvent
from .registry import OPS, get_op, lower_grad_op
from .selected_rows import SelectedRows, densify_maybe

__all__ = ["dce_mask", "analyze_block", "RunPlan", "build_plan", "run_step"]


class _RunContextError(RuntimeError):
    """Lowering failure annotated with op/block/shape context."""


def dce_mask(program, block_idx, fetch_names):
    """Keep ops reachable from the fetch targets or writing persistable
    state (interpreter side-effect semantics), as the reference does.  A
    test-mode program (clone(for_test=True)) never runs its training-only
    ops, though they write persistable state: an is_test run steps no
    optimizer."""
    blk = program.block(block_idx)

    def is_persistable(name):
        v = blk._find_var_recursive(name)
        return v is not None and v.persistable

    is_test = getattr(program, "_is_test", False)
    train_roles = ("backward", "optimize", "lrsched", "loss", "rpc")
    needed = set(fetch_names)
    keep = [False] * len(blk.ops)
    for i in range(len(blk.ops) - 1, -1, -1):
        op = blk.ops[i]
        if is_test and op.attrs.get("op_role") in train_roles:
            continue
        outs = op.output_arg_names()
        if any(n in needed for n in outs) or any(is_persistable(n) for n in outs):
            keep[i] = True
            needed.update(op.input_arg_names())
    return keep


def analyze_block(program, block_idx, feed_names, fetch_names, keep=None):
    """(reads, writes): names the kept ops read before any kept op
    writes them (scope state), and every name they write.  `keep` is a
    mask over the block's ops; None keeps every op."""
    defined = set(feed_names)
    reads, writes = [], []
    for i, op in enumerate(program.block(block_idx).ops):
        if keep is not None and not keep[i]:
            continue
        for n in op.input_arg_names():
            if n not in defined and n not in reads:
                reads.append(n)
        for n in op.output_arg_names():
            defined.add(n)
            if n not in writes:
                writes.append(n)
    for n in fetch_names:
        if n not in defined and n not in reads:
            reads.append(n)
    return reads, writes


def _is_grad_op(op):
    return op.type.endswith("_grad") and "__fwd_type__" in op.attrs


class RunPlan:
    def __init__(self, block_idx, keep, state_names, updated, fetch_names,
                 snap_idx=frozenset()):
        self.block_idx = block_idx
        self.keep = keep
        self.state_names = state_names
        self.updated = updated
        self.fetch_names = fetch_names
        # forward ops that overwrite their inputs and whose grad op runs:
        # their inputs are kept as they were before the op ran
        self.snap_idx = snap_idx


def build_plan(program, block_idx, feed_names, fetch_names, scope):
    keep = dce_mask(program, block_idx, fetch_names)
    reads, writes = analyze_block(program, block_idx, feed_names,
                                  fetch_names, keep)
    missing = [n for n in reads if not scope.has_var(n)]
    if missing:
        raise RuntimeError(
            "variables %s are read by the program but neither fed nor found "
            "in scope — run the startup program first" % missing)
    block = program.block(block_idx)

    def is_persistable(name):
        v = block._find_var_recursive(name)
        return v is not None and v.persistable

    updated = [n for n in writes if n in reads or is_persistable(n)]
    snap_idx = set()
    for i, op in enumerate(block.ops):
        if keep[i] and _is_grad_op(op):
            j = op.attrs.get("__fwd_op_idx__")
            fwd = block.ops[j] if j is not None and j < len(block.ops) else None
            if fwd is not None and (set(fwd.output_arg_names())
                                    & set(fwd.input_arg_names())):
                snap_idx.add(j)
    return RunPlan(block_idx, keep, list(reads), updated, list(fetch_names),
                   frozenset(snap_idx))


def run_step(program, plan, feeds, state, ctx):
    """One run of the plan's kept ops as a function of tensors alone, the
    counterpart of the reference's ``build_traced_function``: from the
    feeds and the state the block reads (each by name) to (the fetched
    tensors, {name: value} of the plan's updated vars).  No scope is
    read or written here, so a CUDA graph can capture it
    (``core/graph.py``)."""
    env = dict(state)
    env.update(feeds)
    blk = program.block(plan.block_idx)
    ctx.block = blk
    if ctx.draws is not None:
        ctx.draws.start()
    snapshots = {}
    for idx, op in enumerate(blk.ops):
        if not plan.keep[idx]:
            continue
        ctx.op_idx = (plan.block_idx << 20) | idx
        is_grad = _is_grad_op(op)
        snap = snapshots.get(op.attrs.get("__fwd_op_idx__")) if is_grad else None
        if idx in plan.snap_idx:
            snapshots[idx] = {n: env[n] for n in op.input_arg_names()
                              if n in env}
        ins = {}
        for slot, names in op.inputs.items():
            use_snap = snap if not slot.endswith("@GRAD") else None
            vals = []
            for n in names:
                if use_snap is not None and n in use_snap:
                    vals.append(use_snap[n])
                    continue
                if n not in env:
                    raise RuntimeError("op %s reads undefined var %s"
                                       % (op.type, n))
                vals.append(env[n])
            ins[slot] = vals
        opdef = OPS.get(op.type)
        if not (opdef is not None and opdef.handles_selected_rows) and any(
                isinstance(v, SelectedRows) for vals in ins.values()
                for v in vals):
            ins = {s: [densify_maybe(v) for v in vals]
                   for s, vals in ins.items()}
        try:
            if is_grad:
                lower = opdef.lower if opdef is not None else lower_grad_op
                with RecordEvent("op_grad", cat=op.attrs["__fwd_type__"]):
                    outs = lower(ctx, ins, op.attrs)
            else:
                outs = get_op(op.type).lower(ctx, ins, op.attrs)
        except Exception as e:
            shapes = {slot: [tuple(getattr(v, "shape", ())) for v in vals]
                      for slot, vals in ins.items()}
            raise _RunContextError(
                "while running op '%s' (block %d, op %d) with input shapes "
                "%s: %s: %s" % (op.type, plan.block_idx, idx, shapes,
                                type(e).__name__, e)) from e
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot) or ()):
                if n and v is not None:
                    env[n] = v
    fetches = []
    for n in plan.fetch_names:
        if n not in env:
            raise RuntimeError("fetch var %s was never produced" % n)
        fetches.append(densify_maybe(env[n]))
    return fetches, {n: densify_maybe(env[n]) for n in plan.updated
                     if n in env}
