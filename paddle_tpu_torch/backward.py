"""Autodiff over the IR (the counterpart of ``paddle_tpu/backward.py``).

``append_backward(loss)`` walks the block's ops in reverse and emits one
``<type>_grad`` op per forward op on the path to the loss, plus ``sum``
ops where a var's gradient has several contributions.  Grad ops carry
the forward op's type, attrs, slots and index as ``__fwd_*__`` attrs
and are lowered generically (``core/registry.py`` ``lower_grad_op``),
so every gradient is the vjp of its forward rule.  Op order, grad var
names and attrs are the reference's, so a program built here lists the
same ops as one built there.
"""

from . import unique_name
from .core.registry import OPS
from .framework import Parameter, grad_var_name

__all__ = ["append_backward"]

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def _is_float_var(block, name):
    v = block._find_var_recursive(name)
    return v is not None and v.dtype in _FLOAT_DTYPES


def _create_grad_var(block, ref_name, grad_name):
    ref = block._find_var_recursive(ref_name)
    return block.create_var(
        name=grad_name, shape=ref.shape if ref is not None else None,
        dtype=ref.dtype if ref is not None else "float32",
        persistable=False, stop_gradient=True)


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append grad ops for `loss` to its program; return [(param, grad)]."""
    program = loss.block.program
    block = program.global_block()
    with program._op_role_guard("backward"):
        return _append_backward_impl(loss, program, block,
                                     set(no_grad_set or ()), parameter_list)


def _append_backward_impl(loss, program, block, no_grad, parameter_list):
    ops = block.ops
    n_fwd = len(ops)  # ops appended below never join the walk
    needed = {loss.name}
    on_path = [False] * n_fwd
    for i in range(n_fwd - 1, -1, -1):
        op = ops[i]
        if op.type.endswith("_grad"):
            continue
        if any(n in needed for n in op.output_arg_names()):
            on_path[i] = True
            needed.update(op.input_arg_names())

    contribs = {}  # var -> [grad var names]
    finalized = {}

    def finalize(name):
        """The single accumulated grad var of `name` (a sum op where
        several ops contributed)."""
        if name in finalized:
            return finalized[name]
        c = contribs.get(name, [])
        if not c:
            return None
        if len(c) == 1:
            finalized[name] = c[0]
            return c[0]
        gname = grad_var_name(name)
        if gname in c:
            gname = unique_name.generate(gname + "_acc")
        _create_grad_var(block, name, gname)
        block.append_op("sum", inputs={"X": list(c)}, outputs={"Out": [gname]})
        finalized[name] = gname
        return gname

    loss_grad = grad_var_name(loss.name)
    _create_grad_var(block, loss.name, loss_grad)
    block.append_op(
        "fill_constant", outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape) if loss.shape else [1],
               "dtype": loss.dtype, "value": 1.0})
    contribs[loss.name] = [loss_grad]
    finalized[loss.name] = loss_grad

    for i in range(n_fwd - 1, -1, -1):
        if not on_path[i]:
            continue
        op = ops[i]
        out_grads = {slot: [finalize(n) for n in names]
                     for slot, names in op.outputs.items()}
        if not any(g for gs in out_grads.values() for g in gs):
            continue

        gin = {slot: list(names) for slot, names in op.inputs.items()}
        for slot, names in op.outputs.items():
            gs = out_grads[slot]
            if all(g is None for g in gs):
                continue
            filled = []
            for n, g in zip(names, gs):
                if g is None:
                    # zero-fill a missing output grad so slot lists align
                    zname = unique_name.generate(grad_var_name(n) + "_zero")
                    _create_grad_var(block, n, zname)
                    block.append_op("fill_zeros_like", inputs={"X": [n]},
                                    outputs={"Out": [zname]})
                    filled.append(zname)
                else:
                    filled.append(g)
            gin[slot + "@GRAD"] = filled

        # grads of the differentiable float inputs; the op's no-grad
        # slots (ids, labels, optimizer state) never get grad vars
        opdef = OPS.get(op.type)
        no_grad_slots = opdef.no_grad_inputs if opdef else set()
        gout = {}
        for slot, names in op.inputs.items():
            if slot in no_grad_slots:
                continue
            outs, produce = [], False
            for n in names:
                v = block._find_var_recursive(n)
                if (n in no_grad or not _is_float_var(block, n)
                        or (v is not None and v.stop_gradient
                            and not isinstance(v, Parameter))):
                    outs.append(None)
                    continue
                gname = unique_name.generate(grad_var_name(n))
                _create_grad_var(block, n, gname)
                contribs.setdefault(n, []).append(gname)
                outs.append(gname)
                produce = True
            if produce:
                gout[slot + "@GRAD"] = ["" if o is None else o for o in outs]
        if not gout:
            continue
        block.append_op(
            op.type + "_grad", inputs=gin, outputs=gout,
            attrs={"__fwd_type__": op.type,
                   "__fwd_attrs__": dict(op.attrs),
                   "__fwd_in_slots__": list(op.inputs.keys()),
                   "__fwd_out_slots__": list(op.outputs.keys()),
                   "__fwd_out_names__": {k: list(v)
                                         for k, v in op.outputs.items()},
                   "__fwd_op_idx__": i})

        # an op that overwrites a var it reads (in place) breaks the
        # one-writer assumption of the name-keyed accumulator: the grads
        # gathered so far belong to the var after the op and were just
        # consumed as this op's output grad.  Earlier ops see only the
        # grad this op produced for the var as it was before the op.
        in_names = set(op.input_arg_names())
        for n in set(op.output_arg_names()) & in_names:
            if not _is_float_var(block, n):
                continue
            newg = None
            for slot, names in op.inputs.items():
                for nm, g in zip(names, gout.get(slot + "@GRAD") or ()):
                    if nm == n and g:
                        newg = g
            contribs[n] = [newg] if newg else []
            finalized.pop(n, None)

    # finalize every remaining accumulated grad (the executor drops the
    # sum ops nothing reads) and publish the name map
    for name in list(contribs):
        finalize(name)
    if not hasattr(program, "_grad_names"):
        program._grad_names = {}
    program._grad_names.update(finalized)

    if parameter_list is not None:
        params = [block._find_var_recursive(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [v for v in block.vars.values()
                  if isinstance(v, Parameter) and v.trainable]
    params_grads = []
    for p in params:
        g = finalize(p.name)
        if g is not None:
            params_grads.append((p, block._find_var_recursive(g)))
    return params_grads
