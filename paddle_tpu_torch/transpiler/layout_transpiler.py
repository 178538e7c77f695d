"""NHWC layout rewrite for conv trunks (the counterpart of
``paddle_tpu/transpiler/layout_transpiler.py``), op for op the
reference's: every conv/pool/BN/activation/residual-add trunk moves to
NHWC,

- with one ``transpose2`` where an NCHW var enters a conv,
- the trunk ops taking NHWC through their ``data_format`` /
  ``data_layout`` attr (conv2d, depthwise_conv2d, pool2d, batch_norm) or
  being layout-agnostic (the activations, dropout, cast, a same-shape
  elementwise_add),
- and one ``transpose2`` back to NCHW where a trunk var reaches any
  other consumer (reshape, fc's mul, ...), emitted only where needed.

Trunk intermediates then exist only as their ``@NHWC`` aliases; a var
named in ``program._protected_fetch_names`` before the pass stays
materialized in NCHW.  On the card the NHWC lowerings hand cuDNN and
PyTorch's pooling and batch-norm kernels channels-last tensors
(``ops/nn_ops.py``).  Run it before ``optimizer.minimize`` so that the
grad ops differentiate through the transposes.
"""

from .. import framework

NHWC_PERM = (0, 2, 3, 1)
NCHW_PERM = (0, 3, 1, 2)

# unary ops whose lowering is elementwise over X -> Out and therefore
# layout-agnostic
_UNARY = ("relu", "relu6", "leaky_relu", "gelu", "sigmoid", "tanh", "sqrt",
          "abs")


def _permuted(shape):
    if shape and len(shape) == 4:
        return [shape[i] for i in NHWC_PERM]
    return list(shape) if shape else shape


def rewrite_nhwc(program=None):
    """Rewrite (in place) the conv trunk of `program`'s global block to
    NHWC; returns the number of ops flipped to NHWC.  The reference also
    keeps NCHW copies of the vars its sub-block ops read; the port has no
    sub-block op yet (control flow is ROADMAP A6c), so an op that owns a
    sub-block raises."""
    program = program or framework.default_main_program()
    block = program.global_block()
    for op in block.ops:
        if any(a.startswith("sub_block") for a in op.attrs):
            raise NotImplementedError(
                "rewrite_nhwc: op '%s' owns a sub-block; control flow is not "
                "ported yet (ROADMAP A6c)" % op.type)

    new_ops = []
    nhwc = {}  # original var name -> its @NHWC alias
    materialized = set()  # original names also produced in NCHW
    produced = {}  # whether the alias has been written in the new stream
    count = 0

    def alias_for(name):
        """Create (once) the NHWC alias var of `name`."""
        if name in nhwc:
            return nhwc[name]
        v = block._find_var_recursive(name)
        alias = name + "@NHWC"
        block.create_var(
            name=alias,
            shape=_permuted(list(v.shape)) if v is not None and v.shape
            else None,
            dtype=str(v.dtype) if v is not None else "float32")
        nhwc[name] = alias
        return alias

    def transpose(src, dst, perm):
        op = framework.Operator(block, "transpose2", None, None,
                                {"axis": list(perm)})
        op.inputs = {"X": [src]}
        op.outputs = {"Out": [dst]}
        new_ops.append(op)

    def to_nhwc(name):
        """The NHWC view of `name`, with an entry transpose if needed."""
        if name in nhwc and produced.get(name):
            return nhwc[name]
        alias = alias_for(name)
        transpose(name, alias, NHWC_PERM)
        produced[name] = True
        return alias

    def to_nchw(name):
        """Materialize the original NCHW `name` from its alias (once)."""
        if name not in nhwc or name in materialized:
            return
        transpose(nhwc[name], name, NCHW_PERM)
        materialized.add(name)

    def rewire_out(op, slot):
        out = op.outputs[slot][0]
        op.outputs[slot] = [alias_for(out)]
        produced[out] = True

    def var_shape(name):
        v = block._find_var_recursive(name)
        return list(v.shape) if v is not None and v.shape else None

    for op in list(block.ops):
        t = op.type
        x = (op.inputs.get("X") or [None])[0]
        if t in ("conv2d", "depthwise_conv2d") and op.attrs.get(
                "data_format", "NCHW") == "NCHW":
            op.inputs["Input"] = [to_nhwc(op.inputs["Input"][0])]
            op.attrs["data_format"] = "NHWC"
            rewire_out(op, "Output")
            count += 1
        elif t == "pool2d" and x in nhwc and op.attrs.get(
                "data_format", "NCHW") == "NCHW":
            op.inputs["X"] = [to_nhwc(x)]
            op.attrs["data_format"] = "NHWC"
            rewire_out(op, "Out")
            count += 1
        elif t == "batch_norm" and x in nhwc:
            op.inputs["X"] = [to_nhwc(x)]
            op.attrs["data_layout"] = "NHWC"
            rewire_out(op, "Y")
            count += 1
        elif t in _UNARY + ("cast", "dropout") and x in nhwc:
            op.inputs["X"] = [to_nhwc(x)]
            rewire_out(op, "Out")
            if t == "dropout" and op.outputs.get("Mask"):
                rewire_out(op, "Mask")
        elif (t == "elementwise_add"
              and (x in nhwc or op.inputs["Y"][0] in nhwc)
              and op.attrs.get("axis", -1) in (-1, 0)
              and var_shape(x) == var_shape(op.inputs["Y"][0])):
            op.inputs["X"] = [to_nhwc(x)]
            op.inputs["Y"] = [to_nhwc(op.inputs["Y"][0])]
            rewire_out(op, "Out")
        else:
            # any other consumer reads the NCHW materialization
            for name in op.input_arg_names():
                to_nchw(name)
        new_ops.append(op)

    # protected fetch targets stay materialized in NCHW even where every
    # remaining consumer reads the alias
    for name in getattr(program, "_protected_fetch_names", ()):
        to_nchw(name)

    block.ops = new_ops
    return count
