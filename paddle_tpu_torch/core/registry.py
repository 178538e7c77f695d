"""Op registry: op type -> PyTorch lowering rule (the counterpart of
``paddle_tpu/core/registry.py``).

Each op registers one lowering: a plain function from input tensors
(``{slot: [tensor]}``) plus static attrs to output tensors.  The same
rule runs the op in the executor and, on ``meta`` tensors, infers its
output shapes at build time (``layer_helper.infer_shape``).

Gradients come from the lowering itself: an op ``<type>_grad`` built by
``backward.py`` is lowered generically by ``lower_grad_op``, the vjp
(``torch.func.vjp``) of the forward rule, as the reference lowers it
with ``jax.vjp``.  Ops whose forward rule sits on a kernel get the
kernel's ``torch.autograd.Function`` backward through the same vjp.
"""

import contextlib
import functools

import torch

__all__ = ["register", "get_op", "is_registered", "LowerCtx", "DrawSites",
           "OPS", "lower_grad_op"]


class OpDef:
    def __init__(self, type, lower, no_grad_inputs=None, guard=None,
                 handles_selected_rows=False):
        self.type = type
        self.lower = lower  # fn(ctx, ins, attrs) -> {slot: [tensors]}
        # input slots that never take a gradient (ids, labels, optimizer
        # state), beside the integer inputs, which never do
        self.no_grad_inputs = set(no_grad_inputs or ())
        # the context the rule runs under, its vjp's backward too (the
        # convs' cuDNN settings, read when each kernel is dispatched)
        self.guard = guard or contextlib.nullcontext
        # ops that take SelectedRows inputs as they are (the sparse
        # gradient's consumers); every other op gets them densified by
        # the block runner (core/trace.py)
        self.handles_selected_rows = handles_selected_rows


OPS = {}


def register(type_, no_grad_inputs=None, guard=None,
             handles_selected_rows=False):
    """Decorator: register a lowering rule for op `type_`; `guard` makes
    the context its rule and its grad run under; `handles_selected_rows`
    lets SelectedRows inputs reach the rule undensified."""

    def deco(fn):
        lower = fn
        if guard is not None:
            @functools.wraps(fn)
            def lower(ctx, ins, attrs):
                with guard():
                    return fn(ctx, ins, attrs)
        OPS[type_] = OpDef(type_, lower, no_grad_inputs, guard,
                           handles_selected_rows)
        return fn

    return deco


def get_op(type_):
    if type_ not in OPS:
        raise NotImplementedError(
            "op '%s' has no PyTorch lowering registered (known: %d ops)"
            % (type_, len(OPS)))
    return OPS[type_]


def is_registered(type_):
    return type_ in OPS


_MASK64 = 0xFFFFFFFFFFFFFFFF


def _mix64(z):
    """splitmix64 finalizer: a full-avalanche 64-bit mix."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_seed(seed, *data):
    """Fold integers into a seed, order-sensitive (the counterpart of
    jax.random.fold_in on the reference's threefry keys)."""
    z = _mix64(int(seed) & _MASK64)
    for d in data:
        z = _mix64(z ^ _mix64(int(d) & _MASK64))
    return z & 0x7FFFFFFFFFFFFFFF


class DrawSites:
    """One ``torch.Generator`` per random draw of a step, in draw order,
    made at the step's first run and kept with its cache entry, so a
    captured CUDA graph can replay the draws (each generator is
    registered with the graph).  A draw's generator is seeded with
    ``fold_seed(step seed, kind, value)``, the fold the fresh generators
    of the eager runner take, so it starts at offset 0 and draws what a
    fresh one draws.  A grad op that re-runs its forward op's draw has a
    generator of its own with the same seed: one shared generator would
    have advanced between the two draws."""

    def __init__(self, device):
        self.device = device
        self.gens = []
        self.keys = []  # (kind, value) of each draw
        self.pos = 0
        self.capturing = False  # draws recorded into a graph: seeded later

    def start(self):
        self.pos = 0

    def next(self, kind, value, seed):
        i = self.pos
        self.pos += 1
        if i == len(self.gens):
            if self.capturing:
                raise RuntimeError(
                    "a random draw appeared during capture that the step's "
                    "first run did not make")
            self.gens.append(torch.Generator(device=self.device))
            self.keys.append((kind, value))
        elif self.keys[i] != (kind, value):
            raise RuntimeError("random draw %d changed from %s to %s between "
                               "runs of one step" % (i, self.keys[i],
                                                     (kind, value)))
        g = self.gens[i]
        if not self.capturing:
            g.manual_seed(seed)
        return g

    def reseed(self, step_seed):
        """Seed every draw for a replay of the step at `step_seed`."""
        for g, (kind, value) in zip(self.gens, self.keys):
            g.manual_seed(fold_seed(step_seed, kind, value))


class LowerCtx:
    """Per-run context handed to lowering rules: the run's base seed
    (the executor folds in its step counter), the device, the block
    being run and the op's index in it (the mesh-aware lowerings read
    the op's weight names through ``block.ops[op_idx]``).  `draws` (a
    ``DrawSites``) and `consts` belong to a cache entry and outlive the
    run; without them each draw takes a fresh generator and each
    constant is made anew."""

    def __init__(self, seed=0, device=None, block=None, draws=None,
                 consts=None):
        self.seed = int(seed)
        self.device = torch.device(device) if device is not None else None
        self.block = block
        self.op_idx = 0
        self.draws = draws
        self.consts = consts if consts is not None else {}

    def rng(self, attrs=None):
        """A seeded ``torch.Generator`` on the run's device for a
        randomness-consuming op.  A nonzero `seed` attr replaces the
        op-position fold, so ops sharing a seed share a stream (the
        reference's per-op seed-attr semantics).  The streams differ
        from the reference's threefry draws: parity tests feed both
        packages the same numpy inputs instead."""
        if self.device is not None and self.device.type == "meta":
            return None  # shape inference draws nothing
        seed = int(attrs.get("seed", 0)) if attrs else 0
        kind, value = (1, seed) if seed else (2, self.op_idx)
        folded = fold_seed(self.seed, kind, value)
        if self.draws is not None:
            return self.draws.next(kind, value, folded)
        g = torch.Generator(device=self.device or "cpu")
        g.manual_seed(folded)
        return g

    def constant(self, make):
        """The op's constant tensor: `make()` at its first run, kept for
        the entry's later runs, so a captured step copies nothing from
        the host."""
        t = self.consts.get(self.op_idx)
        if t is None:
            if self.draws is not None and self.draws.capturing:
                raise RuntimeError(
                    "a constant appeared during capture that the step's "
                    "first run did not make")
            t = self.consts[self.op_idx] = make()
        return t


def lower_grad_op(ctx, ins, attrs):
    """Generic lowering of a ``<type>_grad`` op: the vjp of the forward
    rule (the reference's ``lower_grad_op``, ``torch.func.vjp`` in place
    of ``jax.vjp``).

    The grad op (built by ``backward.py``) carries the forward op's
    type, attrs, input and output slots, output names and index as
    ``__fwd_*__`` attrs.  Its inputs are the forward inputs under their
    slot names plus ``<out-slot>@GRAD``; its outputs are
    ``<in-slot>@GRAD`` for the differentiable inputs: the float inputs
    outside the op's ``no_grad_inputs``.  A missing output cotangent is
    zeros, and an integer output takes none.

    The re-run of the forward rule sees ``op_idx = __fwd_op_idx__`` and
    the same block, so a random op (dropout) draws the forward op's mask
    again and a mesh-aware lowering finds the forward op's weights.  That index
    is the forward op's plain position in its block, while the runner
    sets ``(block << 20) | idx``: the two agree in block 0, the only
    block a training program differentiates, as in the reference.
    ``torch.func.vjp`` runs under the executor's ``torch.no_grad()``, and
    both it and the vjp's backward under the op's guard.
    """
    opdef = get_op(attrs["__fwd_type__"])
    fwd_attrs = attrs["__fwd_attrs__"]
    in_slots = attrs["__fwd_in_slots__"]
    out_slots = attrs["__fwd_out_slots__"]
    fwd_ins = {s: ins[s] for s in in_slots if s in ins}
    diff_pos = [(s, i) for s in in_slots
                if s not in opdef.no_grad_inputs and s in fwd_ins
                for i, v in enumerate(fwd_ins[s])
                if torch.is_tensor(v) and v.is_floating_point()]
    sub_ctx = LowerCtx(ctx.seed, ctx.device, ctx.block, ctx.draws,
                       ctx.consts)
    sub_ctx.op_idx = attrs.get("__fwd_op_idx__", ctx.op_idx)
    kept = []  # (slot, index) of each float output, in vjp order

    def fwd_fn(*diff_vals):
        merged = {s: list(v) for s, v in fwd_ins.items()}
        for (s, i), v in zip(diff_pos, diff_vals):
            merged[s][i] = v
        outs = opdef.lower(sub_ctx, merged, fwd_attrs)
        flat = []
        kept.clear()
        for s in out_slots:
            for i, o in enumerate(outs.get(s) or ()):
                if torch.is_tensor(o) and o.is_floating_point():
                    kept.append((s, i))
                    flat.append(o)
        return tuple(flat)

    primals = [fwd_ins[s][i] for s, i in diff_pos]
    if not primals:
        return {}
    with opdef.guard():
        fwd_flat, vjp_fn = torch.func.vjp(fwd_fn, *primals)
        cots = []
        for (s, i), ref in zip(kept, fwd_flat):
            g = ins.get(s + "@GRAD")
            if g is not None and i < len(g) and g[i] is not None:
                cots.append(g[i].to(ref.dtype).reshape(ref.shape))
            else:
                cots.append(torch.zeros_like(ref))
        grads = vjp_fn(tuple(cots))
    result = {}
    for (s, i), g in zip(diff_pos, grads):
        lst = result.setdefault(s + "@GRAD", [])
        lst.extend([None] * (i + 1 - len(lst)))
        lst[i] = g
    return result
