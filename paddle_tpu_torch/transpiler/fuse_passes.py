"""Fuse passes (the counterpart of ``paddle_tpu/transpiler/fuse_passes.py``):
``fc_fuse_pass`` (mul + bias add [+ act] -> fc), ``swiglu_fuse_pass``
(the SwiGLU FFN diamond -> fused_swiglu), ``residual_ln_fuse_pass``
(residual add + layer_norm -> fused_residual_ln), the
``matmul_epilogue_fuse_pass`` bundle the builders apply, and the loss
chain of the training builders: ``smooth_label_xent_fuse_pass``
(one_hot -> label_smooth -> soft-label xent -> smooth_label_xent) and
``linear_xent_fuse_pass`` (vocab projection + xent -> fused_linear_xent).
The fused ops' lowerings sit on the matmul-epilogue, matmul-SwiGLU,
add-LN and linear cross-entropy kernels.

The inference predictor's passes: ``fuse_elewise_add_act_pass`` (add +
act -> fused_elemwise_activation), ``conv_eltadd_relu_fuse_pass``
(conv2d + channel bias add [+ relu] -> conv2d with Bias and fuse_relu),
``seqconv_eltadd_relu_fuse_pass`` (-> fusion_seqconv_eltadd_relu,
whose lowering waits with sequence_conv for ROADMAP A6c: the pass
matches programs made with ``block.append_op``), ``fc_gru_fuse_pass``
and ``fc_lstm_fuse_pass`` (fc / mul + gru / lstm -> fusion_gru /
fusion_lstm, the projection inside the op, on the recurrent kernels),
``seqexpand_concat_fc_fuse_pass`` and ``embedding_fc_lstm_fuse_pass``.
Each pass records how many chains it fused on the program
(``_fc_fused_count`` ...), as the reference does."""

from .. import framework as _fw
from ..analysis.graph import consumer_ops, producer_ops
from .pass_registry import OpPattern, Pass, apply_pass, register_pass

_ACTS = ("relu", "tanh", "sigmoid")

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


def _bias_of_add(block, add, producer_out):
    """The add operand that is NOT `producer_out`, or None."""
    add_ins = add.inputs.get("X", []) + add.inputs.get("Y", [])
    others = [n for n in add_ins if n != producer_out]
    if producer_out not in add_ins or len(others) != 1:
        return None
    return others[0]


def _is_bias_vector(block, name, want, channel_axis_from_end):
    """True for a length-`want` vector laid out so that broadcasting
    against the producer's output applies it along the axis
    `channel_axis_from_end` places from the end: all dims 1 but that
    one (a bare [C] counts only at 0, onto the last axis)."""
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
    k = channel_axis_from_end
    if len(dims) <= k:
        return k == 0 and len(dims) == 1
    return dims[len(dims) - 1 - k] == int(want) and all(
        d == 1 for i, d in enumerate(dims) if i != len(dims) - 1 - k)


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
            bname = _bias_of_add(block, add, mul.outputs["Out"][0])
            if bname is None or not _is_bias_vector(block, bname,
                                                    int(w.shape[-1]), 0):
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

        n = 0
        for pat in ([["mul", "elementwise_add", a] for a in _FC_ACTS]
                    + [["mul", "elementwise_add"]]):
            n += OpPattern(pat).rewrite(block, fuse)
        program._fc_fused_count = n
        return program


@register_pass("fuse_elewise_add_act_pass")
class FuseElewiseAddActPass(Pass):
    """elementwise_add + relu / tanh / sigmoid ->
    fused_elemwise_activation (functor_list [act, elementwise_add]: the
    act of the sum)."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            add, act = chain
            if int(add.attrs.get("axis", -1)) != -1:
                return False  # the fused lowering applies a plain +
            if not _chain_safe(program, chain):
                return False
            fused = _mk_op(
                block, "fused_elemwise_activation",
                {"X": [add.inputs["X"][0]], "Y": [add.inputs["Y"][0]]},
                {"Out": [act.outputs["Out"][0]]},
                {"functor_list": [act.type, "elementwise_add"]})
            _replace_chain(block, program, chain, [fused])
            return True

        n = 0
        for a in _ACTS:
            n += OpPattern(["elementwise_add", a]).rewrite(block, fuse)
        program._elewise_act_fused_count = n
        return program


@register_pass("conv_eltadd_relu_fuse_pass")
class ConvEltaddReluFusePass(Pass):
    """conv2d + elementwise_add (a per-channel bias) [+ relu] -> conv2d
    with its Bias input and the fuse_relu epilogue."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            conv, add = chain[0], chain[1]
            relu = chain[2] if len(chain) == 3 else None
            if conv.inputs.get("Bias"):
                return False  # already biased
            f = block._find_var_recursive(conv.inputs["Filter"][0])
            if f is None or f.shape is None:
                return False
            cout = int(f.shape[0])
            bname = _bias_of_add(block, add, conv.outputs["Output"][0])
            if bname is None:
                return False
            # an NCHW channel bias: [*, C, 1, 1] under plain broadcasting,
            # or a bare [C] under fluid's axis=1 add
            axis = int(add.attrs.get("axis", -1))
            if axis == 1:
                bv = block._find_var_recursive(bname)
                if (bv is None or bv.shape is None
                        or [int(d) for d in bv.shape] != [cout]):
                    return False
            elif not _is_bias_vector(block, bname, cout, 2):
                return False
            if not _chain_safe(program, chain):
                return False
            conv.inputs["Bias"] = [bname]
            conv.outputs["Output"] = [chain[-1].outputs["Out"][0]]
            if relu is not None:
                conv.attrs["fuse_relu"] = True
            # the conv moves to the chain's tail: its new Bias input may
            # be produced between the conv and the add (a reshape)
            _replace_chain(block, program, chain, [conv])
            return True

        n = 0
        for pat in (["conv2d", "elementwise_add", "relu"],
                    ["conv2d", "elementwise_add"]):
            n += OpPattern(pat).rewrite(block, fuse)
        program._conv_eltadd_fused_count = n
        return program


@register_pass("seqconv_eltadd_relu_fuse_pass")
class SeqconvEltaddReluFusePass(Pass):
    """sequence_conv + elementwise_add + relu ->
    fusion_seqconv_eltadd_relu.  Neither op's lowering is ported
    (sequence_conv is ROADMAP A6c): the rewrite itself is the
    reference's."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            sc, add, relu = chain
            f = block._find_var_recursive(sc.inputs["Filter"][0])
            if f is None or f.shape is None:
                return False
            nfilt = int(f.shape[-1])
            bname = _bias_of_add(block, add, sc.outputs["Out"][0])
            if bname is None or not _is_bias_vector(block, bname, nfilt, 0):
                return False
            if not _chain_safe(program, chain):
                return False
            inputs = {"X": sc.inputs["X"], "Filter": sc.inputs["Filter"],
                      "Bias": [bname]}
            if sc.inputs.get("SeqLen"):
                inputs["SeqLen"] = sc.inputs["SeqLen"]
            fused = _mk_op(block, "fusion_seqconv_eltadd_relu", inputs,
                           {"Out": [relu.outputs["Out"][0]]}, sc.attrs)
            _replace_chain(block, program, chain, [fused])
            return True

        program._seqconv_fused_count = OpPattern(
            ["sequence_conv", "elementwise_add", "relu"]).rewrite(block, fuse)
        return program


def _fuse_fc_into_recurrent(program, rec_types, fused_type):
    """fc_gru_fuse_pass / fc_lstm_fuse_pass: an fc (no activation) or a
    bare mul producing the recurrent op's Input becomes its in-op
    WeightX / BiasX projection of the raw [B, T, D] sequence."""
    block = program.global_block()

    def fuse(chain):
        proj, rec = chain
        if rec.inputs.get("WeightX"):
            return False
        if proj.outputs["Out"][0] != rec.inputs["Input"][0]:
            return False
        if not _chain_safe(program, chain):
            return False
        x_in = proj.inputs["Input" if proj.type == "fc" else "X"][0]
        xv = block._find_var_recursive(x_in)
        if xv is None or xv.shape is None or len(xv.shape) != 3:
            return False  # the in-op projection is [B, T, D] @ [D, kH]
        if proj.type == "fc":
            if proj.attrs.get("activation_type"):
                return False
            if int(proj.attrs.get("in_num_col_dims", 1)) != 2:
                return False
            rec.inputs["WeightX"] = proj.inputs["W"]
            if proj.inputs.get("Bias"):
                rec.inputs["BiasX"] = proj.inputs["Bias"]
        else:  # bare mul
            if int(proj.attrs.get("x_num_col_dims", 1)) != 2:
                return False
            rec.inputs["WeightX"] = proj.inputs["Y"]
        rec.inputs["Input"] = [x_in]
        rec.type = fused_type
        block.ops.remove(proj)
        program._bump_version()
        return True

    n = 0
    for rec_type in rec_types:
        for head in ("fc", "mul"):
            n += OpPattern([head, rec_type]).rewrite(block, fuse)
    return n


@register_pass("fc_gru_fuse_pass")
def _fc_gru_fuse(program, scope):
    """fc / mul + gru -> fusion_gru."""
    program._fc_gru_fused_count = _fuse_fc_into_recurrent(
        program, ("gru", "padded_gru"), "fusion_gru")
    return program


@register_pass("fc_lstm_fuse_pass")
def _fc_lstm_fuse(program, scope):
    """fc / mul + lstm -> fusion_lstm."""
    program._fc_lstm_fused_count = _fuse_fc_into_recurrent(
        program, ("lstm", "padded_lstm"), "fusion_lstm")
    return program


@register_pass("seqexpand_concat_fc_fuse_pass")
class SeqexpandConcatFcFusePass(Pass):
    """sequence_expand(s) + concat + fc / mul ->
    fusion_seqexpand_concat_fc, after fc_fuse_pass.  The concat's first
    input is the [B, T, D] sequence; every further input must be a
    single-consumer sequence_expand of a [B, Di] vector.  The port has
    no sequence_expand layer yet (ROADMAP A6c): the pass matches
    programs made with ``block.append_op``."""

    def apply(self, program, scope=None):
        block = program.global_block()
        n = 0
        changed = True
        while changed:
            changed = False
            producers, consumers = producer_ops(block), consumer_ops(block)
            for cat in list(block.ops):
                if cat.type != "concat":
                    continue
                if int(cat.attrs.get("axis", 0)) not in (2, -1):
                    continue
                xs = cat.inputs.get("X", [])
                if len(xs) < 2:
                    continue
                sv = block._find_var_recursive(xs[0])
                if sv is None or sv.shape is None or len(sv.shape) != 3:
                    continue
                expands = []
                for name in xs[1:]:
                    p = producers.get(name)
                    xv = (block._find_var_recursive(p.inputs["X"][0])
                          if p is not None and p.type == "sequence_expand"
                          else None)
                    if (p is None or p.type != "sequence_expand"
                            or xv is None or xv.shape is None
                            or len(xv.shape) != 2
                            or len(consumers.get(name, [])) != 1):
                        expands = None
                        break
                    expands.append(p)
                if not expands:
                    continue
                cat_out = cat.outputs["Out"][0]
                cons = consumers.get(cat_out, [])
                if len(cons) != 1:
                    continue
                proj = cons[0]
                if proj.type == "fc":
                    if int(proj.attrs.get("in_num_col_dims", 1)) != 2:
                        continue
                    if proj.inputs.get("Input", [None])[0] != cat_out:
                        continue
                    weight = proj.inputs["W"]
                    bias = proj.inputs.get("Bias")
                    act = proj.attrs.get("activation_type") or "identity"
                elif proj.type == "mul":
                    if int(proj.attrs.get("x_num_col_dims", 1)) != 2:
                        continue
                    if int(proj.attrs.get("y_num_col_dims", 1)) != 1:
                        continue
                    if proj.inputs.get("X", [None])[0] != cat_out:
                        continue
                    wv = block._find_var_recursive(proj.inputs["Y"][0])
                    if wv is None or wv.shape is None or len(wv.shape) != 2:
                        continue  # the fused lowering takes FCWeight as-is
                    weight = proj.inputs["Y"]
                    bias = None
                    act = "identity"
                else:
                    continue
                if act not in ("identity", "relu", "tanh", "sigmoid"):
                    continue
                chain = expands + [cat, proj]
                if not _chain_safe(program, chain):
                    continue
                inputs = {"X": [xs[0]] + [e.inputs["X"][0] for e in expands],
                          "FCWeight": weight}
                if bias:
                    inputs["FCBias"] = bias
                fused = _mk_op(block, "fusion_seqexpand_concat_fc", inputs,
                               {"Out": [proj.outputs["Out"][0]]},
                               {"fc_activation": act})
                # at the projection's position (every fused input is
                # defined by then); the chain need not be contiguous
                block.ops.insert(block.ops.index(proj), fused)
                for op in chain:
                    block.ops.remove(op)
                program._bump_version()
                n += 1
                changed = True
                break
        program._seqexpand_concat_fc_fused_count = n
        return program


@register_pass("embedding_fc_lstm_fuse_pass")
class EmbeddingFcLstmFusePass(Pass):
    """lookup_table + fc / mul + lstm -> fused_embedding_fc_lstm."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            lt, proj, lstm = chain
            if proj.outputs["Out"][0] != lstm.inputs["Input"][0]:
                return False
            if lt.attrs.get("padding_idx", -1) not in (-1, None):
                return False
            # the embedding must be the projection's DATA side
            emb_out = lt.outputs["Out"][0]
            data_slot = "Input" if proj.type == "fc" else "X"
            if proj.inputs.get(data_slot, [None])[0] != emb_out:
                return False
            inputs = {"Ids": lt.inputs["Ids"], "Embeddings": lt.inputs["W"],
                      "WeightH": lstm.inputs["Weight"]}
            if proj.type == "fc":
                if proj.attrs.get("activation_type"):
                    return False
                if int(proj.attrs.get("in_num_col_dims", 1)) != 2:
                    return False
                inputs["WeightX"] = proj.inputs["W"]
                if proj.inputs.get("Bias"):
                    inputs["BiasX"] = proj.inputs["Bias"]
            else:
                if int(proj.attrs.get("x_num_col_dims", 1)) != 2:
                    return False
                inputs["WeightX"] = proj.inputs["Y"]
            if not _chain_safe(program, chain):
                return False
            for slot in ("Bias", "SeqLen", "H0", "C0"):
                if lstm.inputs.get(slot):
                    inputs[slot] = lstm.inputs[slot]
            fused = _mk_op(block, "fused_embedding_fc_lstm", inputs,
                           dict(lstm.outputs), lstm.attrs)
            _replace_chain(block, program, chain, [fused])
            return True

        n = 0
        for rec in ("lstm", "padded_lstm"):
            for head in ("fc", "mul"):
                n += OpPattern(["lookup_table", head, rec]).rewrite(
                    block, fuse)
        program._emb_fc_lstm_fused_count = n
        return program


@register_pass("residual_ln_fuse_pass")
class ResidualLnFusePass(Pass):
    """elementwise_add(x, y) -> layer_norm  =>  ONE fused_residual_ln op.
    The sum stays a real output under its original name and the fused
    op lands at the add's position, so every other consumer of the sum
    reads a value defined where it used to be."""

    def apply(self, program, scope=None):
        block = program.global_block()
        n = 0
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
                n += 1
                changed = True
                break
        program._residual_ln_fused_count = n
        return program


def _swiglu_diamond(program, block, producers, emul):
    """(gate mul, swish, up mul, x_num_col_dims) when `emul` closes a
    SwiGLU diamond that may fuse, else None."""
    xn = emul.inputs.get("X", [None])[0]
    yn = emul.inputs.get("Y", [None])[0]
    if xn is None or yn is None:
        return None
    for gate_out, up_out in ((xn, yn), (yn, xn)):
        act = producers.get(gate_out)
        umul = producers.get(up_out)
        if (act is None or act.type != "swish" or umul is None
                or umul.type != "mul"):
            continue
        if float(act.attrs.get("beta", 1.0)) != 1.0:
            continue
        gmul = producers.get(act.inputs["X"][0])
        if gmul is None or gmul.type != "mul":
            continue
        if gmul.inputs["X"][0] != umul.inputs["X"][0]:
            continue  # both sides must project the same x
        ncd = int(gmul.attrs.get("x_num_col_dims", 1))
        if ncd != int(umul.attrs.get("x_num_col_dims", 1)):
            continue
        if (int(gmul.attrs.get("y_num_col_dims", 1)) != 1
                or int(umul.attrs.get("y_num_col_dims", 1)) != 1):
            continue
        wg = block._find_var_recursive(gmul.inputs["Y"][0])
        wu = block._find_var_recursive(umul.inputs["Y"][0])
        if (wg is None or wu is None or wg.shape is None or wu.shape is None
                or len(wg.shape) != 2 or list(wg.shape) != list(wu.shape)):
            continue
        # every intermediate has one consumer, in all blocks
        inter = [(gmul.outputs["Out"][0], act), (act.outputs["Out"][0], emul),
                 (umul.outputs["Out"][0], emul)]
        if any(_consumers_all_blocks(program, name) != [consumer]
               for name, consumer in inter):
            continue
        if not _chain_safe(program, [gmul, act, umul, emul]):
            continue
        return gmul, act, umul, ncd
    return None


@register_pass("swiglu_fuse_pass")
class SwigluFusePass(Pass):
    """mul(x, Wg) -> swish beside mul(x, Wu), joined by elementwise_mul
    => ONE fused_swiglu op (the GPT-2 use_swiglu FFN diamond), whose
    lowering runs the matmul_swiglu kernel: the gate and up
    pre-activations never reach device memory.  Conditions, as the
    reference's: beta-1 swish, the same x and flatten dims on both muls,
    2-D weights of one shape, single-consumer intermediates across all
    blocks, protected fetches."""

    def apply(self, program, scope=None):
        block = program.global_block()
        n = 0
        changed = True
        while changed:
            changed = False
            producers = producer_ops(block)
            for emul in list(block.ops):
                if (emul.type != "elementwise_mul"
                        or int(emul.attrs.get("axis", -1)) != -1):
                    continue
                hit = _swiglu_diamond(program, block, producers, emul)
                if hit is None:
                    continue
                gmul, act, umul, ncd = hit
                fused = _mk_op(
                    block, "fused_swiglu",
                    {"X": [gmul.inputs["X"][0]], "GateW": gmul.inputs["Y"],
                     "UpW": umul.inputs["Y"]},
                    {"Out": [emul.outputs["Out"][0]]},
                    {"x_num_col_dims": ncd})
                # at the elementwise_mul's slot, where every fused input
                # is defined (the chain need not be contiguous)
                block.ops.insert(block.ops.index(emul), fused)
                for op in (gmul, act, umul, emul):
                    block.ops.remove(op)
                program._bump_version()
                n += 1
                changed = True
                break
        program._swiglu_fused_count = n
        return program


@register_pass("matmul_epilogue_fuse_pass")
def _matmul_epilogue_fuse(program, scope):
    """fc (mul + bias + act), SwiGLU diamonds and residual-add +
    layer_norm pairs collapse into their fused ops, in the reference's
    order: fc_fuse_pass needs a bias add, so the bias-free SwiGLU gate
    (mul -> swish) survives it for swiglu_fuse_pass."""
    for name in ("fc_fuse_pass", "swiglu_fuse_pass",
                 "residual_ln_fuse_pass"):
        apply_pass(program, name, scope=scope)
    program._matmul_epilogue_fused_count = (
        program._fc_fused_count + program._swiglu_fused_count
        + program._residual_ln_fused_count)
    return program


@register_pass("smooth_label_xent_fuse_pass")
class SmoothLabelXentFusePass(Pass):
    """one_hot -> label_smooth -> softmax_with_cross_entropy(soft_label)
    => ONE smooth_label_xent op reading the int labels, so no [N, V]
    one-hot, smoothed-label or log-softmax array exists.  Conditions, as
    the reference's: uniform prior (no PriorDist), soft labels, no
    ignore_index, the xent's Softmax output unread, the logits' last dim
    equal to the one_hot depth, no other reader of the intermediates."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            oh, smooth, xent = chain
            if not bool(xent.attrs.get("soft_label", False)):
                return False
            if int(xent.attrs.get("ignore_index", -100)) >= 0:
                return False
            if smooth.inputs.get("PriorDist"):
                return False
            if not _chain_safe(program, chain):
                return False
            softmax_out = xent.outputs.get("Softmax", [None])[0]
            if softmax_out:
                protected = getattr(program, "_protected_fetch_names", ())
                if softmax_out in protected or _consumers_all_blocks(
                        program, softmax_out, exclude=(xent,)):
                    return False
            if _consumers_all_blocks(program, oh.outputs["Out"][0],
                                     exclude=(oh, smooth)):
                return False
            if _consumers_all_blocks(program, smooth.outputs["Out"][0],
                                     exclude=(smooth, xent)):
                return False
            logits_name = xent.inputs["Logits"][0]
            lv = block._find_var_recursive(logits_name)
            if lv is None or lv.shape is None:
                return False
            if int(lv.shape[-1]) != int(oh.attrs.get("depth", -1)):
                return False
            fused = _mk_op(
                block, "smooth_label_xent",
                {"Logits": [logits_name], "Label": [oh.inputs["X"][0]]},
                {"Loss": list(xent.outputs["Loss"])},
                {"epsilon": float(smooth.attrs.get("epsilon", 0.0))})
            _replace_chain(block, program, chain, [fused])
            return True

        program._smooth_xent_fused_count = OpPattern(
            ["one_hot", "label_smooth", "softmax_with_cross_entropy"]
        ).rewrite(block, fuse)
        return program


@register_pass("linear_xent_fuse_pass")
class LinearXentFusePass(Pass):
    """The vocab projection (mul, or matmul(transpose_Y) for tied
    embeddings) feeding softmax_with_cross_entropy (hard label) or
    smooth_label_xent => ONE fused_linear_xent op: the [R, V] logits and
    their gradient never exist in device memory.  Conditions, as the
    reference's: 2-D weight, a mul split at the last axis, hard labels,
    no ignore_index, the Softmax output unread, single-consumer logits.
    Out-of-range labels get the smoothing term only after fusion (the
    one_hot convention)."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            proj, xent = chain
            x_name, w_name = proj.inputs["X"][0], proj.inputs["Y"][0]
            if proj.type == "mul":
                if int(proj.attrs.get("y_num_col_dims", 1)) != 1:
                    return False
                xv = block._find_var_recursive(x_name)
                if xv is None or xv.shape is None:
                    return False
                if int(proj.attrs.get("x_num_col_dims", 1)) != len(xv.shape) - 1:
                    return False
                transpose_w = False
            else:  # matmul: only the tied-embedding x @ W^T form
                if (not proj.attrs.get("transpose_Y", False)
                        or proj.attrs.get("transpose_X", False)
                        or float(proj.attrs.get("alpha", 1.0)) != 1.0):
                    return False
                transpose_w = True
            wv = block._find_var_recursive(w_name)
            if wv is None or wv.shape is None or len(wv.shape) != 2:
                return False
            logits_name = proj.outputs["Out"][0]
            if xent.inputs.get("Logits", [None])[0] != logits_name:
                return False
            if xent.type == "softmax_with_cross_entropy":
                if bool(xent.attrs.get("soft_label", False)):
                    return False
                if int(xent.attrs.get("ignore_index", -100)) >= 0:
                    return False
                softmax_out = xent.outputs.get("Softmax", [None])[0]
                if softmax_out:
                    protected = getattr(program, "_protected_fetch_names", ())
                    if softmax_out in protected or _consumers_all_blocks(
                            program, softmax_out, exclude=(xent,)):
                        return False
                eps = 0.0
            else:
                eps = float(xent.attrs.get("epsilon", 0.0))
            if _consumers_all_blocks(program, logits_name, exclude=(xent,)):
                return False
            if not _chain_safe(program, chain):
                return False
            fused = _mk_op(
                block, "fused_linear_xent",
                {"X": [x_name], "W": [w_name],
                 "Label": list(xent.inputs["Label"])},
                {"Loss": list(xent.outputs["Loss"])},
                {"epsilon": eps, "transpose_w": transpose_w})
            _replace_chain(block, program, chain, [fused])
            return True

        n = 0
        for head in ("mul", "matmul"):
            for tail in ("softmax_with_cross_entropy", "smooth_label_xent"):
                n += OpPattern([head, tail]).rewrite(block, fuse)
        program._linear_xent_fused_count = n
        return program
