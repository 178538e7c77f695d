"""Fuse passes (the counterpart of ``paddle_tpu/transpiler/fuse_passes.py``):
``fc_fuse_pass`` (mul + bias add [+ act] -> fc), ``residual_ln_fuse_pass``
(residual add + layer_norm -> fused_residual_ln) and the
``matmul_epilogue_fuse_pass`` bundle the decode and serving builders
apply.  The fused ops' lowerings sit on the matmul-epilogue and add-LN
kernels.  SwiGLU fusion waits for the matmul_swiglu kernel (ROADMAP
B6)."""

from .. import framework as _fw
from .pass_registry import OpPattern, Pass, apply_pass, register_pass

# fc epilogue activations (the matmul-epilogue kernel's set); gelu fuses
# only in its exact-erf form and swish only at beta=1
_FC_ACTS = ("relu", "tanh", "sigmoid", "gelu", "swish")


def _act_fusable(act_op):
    if act_op.type == "gelu":
        return not act_op.attrs.get("approximate", False)
    if act_op.type == "swish":
        return float(act_op.attrs.get("beta", 1.0)) == 1.0
    return True


def _mk_op(block, type_, inputs, outputs, attrs):
    op = _fw.Operator(block, type_, None, None, dict(attrs))
    op.inputs = inputs
    op.outputs = outputs
    return op


def _chain_safe(program, chain):
    """A fuse deletes every intermediate of its chain; names in
    program._protected_fetch_names must survive."""
    protected = getattr(program, "_protected_fetch_names", None)
    if not protected:
        return True
    return not any(n in protected for op in chain[:-1]
                   for n in op.output_arg_names())


def _replace_chain(block, program, chain, new_ops):
    """Swap a matched chain for new ops at the position of its first op
    (counted as the reference does: the last op's index minus the chain
    length)."""
    idx = block.ops.index(chain[-1]) - (len(chain) - 1)
    for op in chain:
        block.ops.remove(op)
    for j, op in enumerate(new_ops):
        block.ops.insert(idx + j, op)
    program._bump_version()


def _bias_of_add(add, producer_out):
    """The add operand that is NOT `producer_out`, or None."""
    add_ins = add.inputs.get("X", []) + add.inputs.get("Y", [])
    others = [n for n in add_ins if n != producer_out]
    if producer_out not in add_ins or len(others) != 1:
        return None
    return others[0]


def _is_bias_vector(block, name, want):
    """True for a length-`want` vector that broadcasts onto the last
    axis (the reference's check at channel_axis_from_end = 0)."""
    v = block._find_var_recursive(name)
    if v is None or v.shape is None:
        return False
    dims = [int(d) for d in v.shape]
    if any(d < 0 for d in dims):
        return False
    n = 1
    for d in dims:
        n *= d
    if n != int(want):
        return False
    if len(dims) == 0:
        return False
    return dims[-1] == int(want) and all(d == 1 for d in dims[:-1])


def _consumers_all_blocks(program, name, exclude=()):
    return [op for blk in program.blocks for op in blk.ops
            if op not in exclude and name in op.input_arg_names()]


@register_pass("fc_fuse_pass")
class FcFusePass(Pass):
    """mul + elementwise_add [+ act] -> fc."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            mul, add = chain[0], chain[1]
            act = chain[2].type if len(chain) == 3 else ""
            if len(chain) == 3 and not _act_fusable(chain[2]):
                return False
            if int(mul.attrs.get("y_num_col_dims", 1)) != 1:
                return False
            w = block._find_var_recursive(mul.inputs["Y"][0])
            if w is None or w.shape is None or len(w.shape) != 2:
                return False
            bname = _bias_of_add(add, mul.outputs["Out"][0])
            if bname is None or not _is_bias_vector(block, bname,
                                                    int(w.shape[-1])):
                return False
            if not _chain_safe(program, chain):
                return False
            fc = _mk_op(
                block, "fc",
                {"Input": mul.inputs["X"], "W": mul.inputs["Y"],
                 "Bias": [bname]},
                {"Out": [chain[-1].outputs["Out"][0]]},
                {"in_num_col_dims": int(mul.attrs.get("x_num_col_dims", 1)),
                 "activation_type": act})
            _replace_chain(block, program, chain, [fc])
            return True

        for pat in ([["mul", "elementwise_add", a] for a in _FC_ACTS]
                    + [["mul", "elementwise_add"]]):
            OpPattern(pat).rewrite(block, fuse)
        return program


@register_pass("residual_ln_fuse_pass")
class ResidualLnFusePass(Pass):
    """elementwise_add(x, y) -> layer_norm  =>  ONE fused_residual_ln op.
    The sum stays a real output under its original name and the fused
    op lands at the add's position, so every other consumer of the sum
    reads a value defined where it used to be."""

    def apply(self, program, scope=None):
        block = program.global_block()
        changed = True
        while changed:
            changed = False
            for add in list(block.ops):
                if add.type != "elementwise_add":
                    continue
                if int(add.attrs.get("axis", -1)) != -1:
                    continue
                xn = add.inputs.get("X", [None])[0]
                yn = add.inputs.get("Y", [None])[0]
                xv = block._find_var_recursive(xn) if xn else None
                yv = block._find_var_recursive(yn) if yn else None
                if (xv is None or yv is None or xv.shape is None
                        or yv.shape is None
                        or list(xv.shape) != list(yv.shape)
                        or any(int(d) < 0 for d in xv.shape[1:])):
                    continue
                add_out = add.outputs["Out"][0]
                lns = [c for c in _consumers_all_blocks(program, add_out)
                       if c.type == "layer_norm"
                       and c.inputs.get("X", [None])[0] == add_out
                       and c in block.ops]
                if len(lns) != 1:
                    continue
                ln = lns[0]
                rank = len(xv.shape)
                if int(ln.attrs.get("begin_norm_axis", 1)) != rank - 1:
                    continue
                if not (ln.inputs.get("Scale") and ln.inputs.get("Bias")):
                    continue
                if not _chain_safe(program, [add, ln]):
                    continue
                outputs = {"Sum": [add_out], "Y": list(ln.outputs.get("Y", []))}
                for slot in ("Mean", "Variance"):
                    if ln.outputs.get(slot):
                        outputs[slot] = list(ln.outputs[slot])
                fused = _mk_op(
                    block, "fused_residual_ln",
                    {"X": [xn], "Y": [yn], "Scale": list(ln.inputs["Scale"]),
                     "Bias": list(ln.inputs["Bias"])},
                    outputs,
                    {"epsilon": float(ln.attrs.get("epsilon", 1e-5)),
                     "begin_norm_axis": rank - 1})
                block.ops.insert(block.ops.index(add), fused)
                block.ops.remove(add)
                block.ops.remove(ln)
                program._bump_version()
                changed = True
                break
        return program


@register_pass("matmul_epilogue_fuse_pass")
def _matmul_epilogue_fuse(program, scope):
    """fc (mul + bias + act) and residual-add + layer_norm pairs collapse
    into their fused ops.  The reference bundle also runs
    swiglu_fuse_pass; the port's builders refuse use_swiglu until the
    matmul_swiglu kernel lands, so no SwiGLU diamond reaches here."""
    for name in ("fc_fuse_pass", "residual_ln_fuse_pass"):
        apply_pass(program, name, scope=scope)
    return program
