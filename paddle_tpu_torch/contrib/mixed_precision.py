"""bfloat16 automatic mixed precision (the counterpart of
``paddle_tpu/contrib/mixed_precision.py``): a Program -> Program rewrite
with no tensor code in it, emitting the reference's op sequence, var
names (``<name>@BF16``, ``<name>@RAW_BF16``, ``<name>@BIAS_BF16``),
dtypes and attrs op for op.

AMP is a training-time rewrite: cast the inputs of every matmul-class op
(mul/matmul/conv2d/depthwise_conv2d and the fused ops above the bf16
kernel forms) to bfloat16 and the result back to float32, then let the
dtype-transparent trunk ops run in bfloat16 between them.  Master
weights, accumulations, reductions, softmax and the optimizer all stay
float32 — the standard bf16 recipe; no loss scaling is needed (bf16 has
float32's exponent range).  On the H100 the bf16 operands reach the
tensor cores at twice TF32's rate and four times the float32 bytes a
product moves are halved.

    loss = ...
    rewrite_bf16(fluid.default_main_program())
    opt.minimize(loss)      # grads flow through the casts
"""

from .. import framework

_BF16_OPS = ("mul", "matmul", "conv2d", "depthwise_conv2d",
             "fused_attention",
             # the matmul-epilogue fused ops (fuse_passes): their pallas
             # kernels/dense paths consume the input dtype and accumulate
             # f32, so bf16 inputs run the tensor cores at full rate
             "fc", "fused_swiglu",
             # logits-free fused loss: bf16 X/W tiles, f32 online
             # logsumexp internals — the projection is the single
             # biggest matmul in the LM programs
             "fused_linear_xent")

# input slots that must stay float32 even when the op is rewritten
# (additive -1e9 padding masks lose nothing in bf16, but keeping them f32
# costs nothing and avoids surprises with user-supplied biases); int
# label slots must never see a float cast at all
_KEEP_F32_SLOTS = {"fused_attention": ("Bias",),
                   "fused_linear_xent": ("Label",)}

# dtype-transparent trunk ops: (data input slots, flippable output slots).
# When every data input of one of these is available in half precision,
# the op itself runs in half — its lowering preserves the input dtype
# (batch_norm/layer_norm compute statistics in f32 internally, nn_ops.py)
# — so the conv->bn->relu->residual-add->pool trunk of a convnet AND the
# mul->bias-add->reshape->transpose->dropout->layer_norm chains of a
# transformer block stay bf16 in HBM instead of bouncing through f32
# between every pair of matmul-class ops.  Parameter/state slots
# (Scale/Bias/Mean/Variance) and state outputs (MeanOut/Saved*/Mask's
# XShape) keep f32.
_TRANSPARENT_OPS = {
    "relu": (("X",), ("Out",)),
    "gelu": (("X",), ("Out",)),
    "pool2d": (("X",), ("Out",)),
    "batch_norm": (("X",), ("Y",)),
    "layer_norm": (("X",), ("Y",)),
    "dropout": (("X",), ("Out",)),
    "reshape2": (("X",), ("Out",)),
    "reshape": (("X",), ("Out",)),
    "transpose2": (("X",), ("Out",)),
    "transpose": (("X",), ("Out",)),
    "scale": (("X",), ("Out",)),
    "elementwise_add": (("X", "Y"), ("Out",)),
    # fused residual-add+LN: both streams half -> the op runs half
    # (stats stay f32 internally, like layer_norm); Scale/Bias params
    # and the Mean/Variance state outputs keep f32
    "fused_residual_ln": (("X", "Y"), ("Sum", "Y")),
}


def _tag_for(dtype):
    return "BF16" if dtype == "bfloat16" else "FP16"


def _emit_cast(block, new_ops, src_name, dst_dtype, out_name):
    """Shared cast-op emitter: create `out_name` in `dst_dtype` (shape
    mirrored from the source var), append the cast op to `new_ops`, and
    return the new name.  in_dtype derives from the source var's declared
    dtype (f32 default)."""
    src = block._find_var_recursive(src_name)
    out = block.create_var(
        name=out_name,
        shape=list(src.shape) if src is not None and src.shape else None,
        dtype=dst_dtype,
    )
    op = framework.Operator(
        block,
        "cast",
        None,
        None,
        {"in_dtype": str(src.dtype) if src is not None else "float32",
         "out_dtype": dst_dtype},
    )
    op.inputs = {"X": [src_name]}
    op.outputs = {"Out": [out.name]}
    new_ops.append(op)
    return out.name


def _emit_raw_and_castback(block, name, dtype, tag):
    """Create the half var `<name>@RAW_<tag>` plus the half->f32 cast op
    restoring `name`; returns (raw_name, cast_back_op).  The caller wires
    the producing op to write the raw var and appends the cast-back after
    it — the shared emission step of both AMP passes."""
    raw = name + "@RAW_" + tag
    v = block._find_var_recursive(name)
    block.create_var(
        name=raw,
        shape=list(v.shape) if v is not None and v.shape else None,
        dtype=dtype,
    )
    cast_back = framework.Operator(
        block,
        "cast",
        None,
        None,
        {"in_dtype": dtype, "out_dtype": "float32"},
    )
    cast_back.inputs = {"X": [raw]}
    cast_back.outputs = {"Out": [name]}
    return raw, cast_back


def rewrite_bf16(program=None, ops=_BF16_OPS, dtype="bfloat16"):
    """Insert half-precision casts around matmul-class ops (in place).
    Must run BEFORE optimizer.minimize so the grad ops differentiate
    through the casts.  Returns the count of rewritten ops.  dtype
    "bfloat16" is the training regime; "float16" mirrors the
    reference's fp16 inference transpiler (paddle/contrib/float16)."""
    program = program or framework.default_main_program()
    tag = _tag_for(dtype)
    block = program.global_block()
    new_ops = []
    count = 0
    cast_cache = {}  # var name -> bf16 var name (reuse within the block)

    def cast_var(name, dst_dtype, tag):
        key = (name, dst_dtype)
        if key not in cast_cache:
            cast_cache[key] = _emit_cast(
                block, new_ops, name, dst_dtype, "%s@%s" % (name, tag))
        return cast_cache[key]

    for op in block.ops:
        if (
            op.type in ops
            and op.attrs.get("op_role", "forward") == "forward"
        ):
            count += 1
            keep_f32 = _KEEP_F32_SLOTS.get(op.type, ())
            for slot, names in list(op.inputs.items()):
                if slot in keep_f32:
                    continue
                op.inputs[slot] = [
                    cast_var(n, dtype, tag) for n in names
                ]
            new_ops.append(op)
            # cast outputs back to f32, keeping downstream names intact:
            # the op writes <out>@RAW_BF16 and a cast restores <out>
            for slot, names in list(op.outputs.items()):
                restored = []
                for n in names:
                    raw, cast_back = _emit_raw_and_castback(
                        block, n, dtype, tag)
                    restored.append((slot, raw, cast_back))
                op.outputs[slot] = [r[1] for r in restored]
                for _, _, cb in restored:
                    new_ops.append(cb)
                    # cast-back redefines the original name: a later bf16
                    # cast of it must re-derive from the new value
                    cast_cache.pop((cb.outputs["Out"][0], dtype), None)
        else:
            new_ops.append(op)
            # anything redefined later must not serve a stale cast
            for names in op.outputs.values():
                for n in names:
                    cast_cache.pop((n, dtype), None)
    block.ops = new_ops
    propagate_half_through_trunk(program, dtype)
    collapse_redundant_casts(program, dtype)
    program._bump_version()
    return count


def propagate_half_through_trunk(program, dtype="bfloat16"):
    """Flip dtype-transparent trunk ops (_TRANSPARENT_OPS) to half.

    An op whose every data input is the f32 cast-back of a half tensor is
    rewired to read the half tensor directly; its data output becomes a
    NEW half var, and a cast-back op re-defines the original f32 name so
    every other consumer (fetches, non-transparent ops, sub-blocks) is
    untouched.  Unused cast-backs are dropped by trace-time DCE, and the
    downstream f32->half re-casts collapse in collapse_redundant_casts —
    net effect: the conv/BN/relu/add/pool trunk runs half end-to-end.
    Returns the number of flipped ops."""
    tag = _tag_for(dtype)
    block = program.global_block()
    castback_src = {}  # f32 name -> half name, current definitions only
    new_ops = []
    flipped = 0
    bias_cast_cache = {}  # f32 bias name -> half name

    def half_bias(name):
        """f32->half cast for a BIAS-LIKE elementwise_add Y operand that
        is not itself half-sourced: standard AMP runs the bias add in
        half; bf16 keeps f32's exponent range so small biases round, not
        underflow.  Callers gate on the operand being a true broadcast
        bias — full-shape f32 activations keep their f32 contract.
        Cached per current definition."""
        if name not in bias_cast_cache:
            bias_cast_cache[name] = _emit_cast(
                block, new_ops, name, dtype, "%s@BIAS_%s" % (name, tag))
        return bias_cast_cache[name]

    def _is_broadcast_bias(xn, yn, axis=-1):
        """True when Y is a true bias operand broadcast onto X: lower
        rank (fluid-style axis-broadcast FC/conv bias, e.g. [D] or [C])
        NOT aligned to the batch dim, or same rank with at most ONE
        non-1 dim — which must not be the batch dim — and every dim
        either 1 or matching X (channel bias [1,C,1,1], feature bias
        [1,1,D]).  Per-sample/partially-broadcast f32 ACTIVATIONS — a
        [B,T,1] gate, [B,1,D] mask, [B,1,1] scalar, or axis=0 [B]
        operand — keep their f32 contract."""
        xv = block._find_var_recursive(xn)
        yv = block._find_var_recursive(yn)
        if xv is None or yv is None or xv.shape is None or yv.shape is None:
            return False
        xs, ys = tuple(xv.shape), tuple(yv.shape)
        if xs == ys:
            return False
        if len(ys) < len(xs):
            # elementwise axis semantics: y aligns to x starting at
            # `axis` (default: trailing).  A y whose first dim rides the
            # batch dim (axis==0 and not a broadcast-1) is per-sample
            # data, not a bias.
            eff_axis = axis if axis >= 0 else len(xs) - len(ys)
            return not (eff_axis == 0 and ys and ys[0] != 1)
        if len(ys) > len(xs):
            return False
        if any(yd not in (1, xd) for yd, xd in zip(ys, xs)):
            return False
        non1 = [i for i, yd in enumerate(ys) if yd != 1]
        return len(non1) <= 1 and 0 not in non1

    for op in block.ops:
        spec = _TRANSPARENT_OPS.get(op.type)
        halves = None
        if spec is not None:
            in_slots, out_slots = spec
            names = [n for s in in_slots for n in op.inputs.get(s, [])]
            if op.type == "elementwise_add":
                # X must be half-sourced; Y joins from castback_src when
                # it is too (residual adds), else only a strictly-smaller
                # broadcast operand (bias add) is cast to half in place —
                # a same-shape f32 activation keeps the add in f32
                xn = op.inputs.get("X", [None])[0]
                yn = op.inputs.get("Y", [None])[0]
                if xn in castback_src and yn is not None:
                    if yn in castback_src:
                        halves = {xn: castback_src[xn],
                                  yn: castback_src[yn]}
                    elif _is_broadcast_bias(
                            xn, yn, int(op.attrs.get("axis", -1))):
                        halves = {xn: castback_src[xn],
                                  yn: half_bias(yn)}
            elif names and all(n in castback_src for n in names):
                halves = {n: castback_src[n] for n in names}
        if halves is not None:
            for s in in_slots:
                if s in op.inputs:
                    op.inputs[s] = [halves.get(n, n) for n in op.inputs[s]]
            new_ops.append(op)
            flipped += 1
            for s in out_slots:
                for i, n in enumerate(list(op.outputs.get(s, []))):
                    raw, cb = _emit_raw_and_castback(block, n, dtype, tag)
                    op.outputs[s][i] = raw
                    new_ops.append(cb)
                    castback_src[n] = raw
            # non-flipped outputs (MeanOut/Saved*) redefine their names
            for s, ns in op.outputs.items():
                if s not in out_slots:
                    for n in ns:
                        castback_src.pop(n, None)
                        bias_cast_cache.pop(n, None)
            if op.type == "dropout":
                # the lowering emits Mask in X's dtype (nn_ops._dropout):
                # keep the declaration truthful for fetches/saves
                for n in op.outputs.get("Mask", []):
                    mv = block._find_var_recursive(n)
                    if mv is not None:
                        mv.dtype = dtype
            continue
        is_castback = (op.type == "cast"
                       and op.attrs.get("out_dtype") == "float32"
                       and op.attrs.get("in_dtype") == dtype)
        for n in op.output_arg_names():
            castback_src.pop(n, None)
            bias_cast_cache.pop(n, None)
        if is_castback:
            castback_src[op.outputs["Out"][0]] = op.inputs["X"][0]
        new_ops.append(op)
    if flipped:
        block.ops = new_ops
        program._bump_version()
    return flipped


def collapse_redundant_casts(program, dtype="bfloat16"):
    """Peephole: when a half->f32 cast-back feeds an f32->half re-cast,
    the re-cast collapses — its consumers read the original half tensor
    directly.  Numerically identical (half->f32->half is exact), but
    consecutive matmul-class ops stop bouncing activations through f32 in
    HBM (matmul->matmul chains in transformer blocks).

    The cast-back itself is KEPT: it still defines the original f32 name,
    which may be a fetch target or a sub-block read the global-block
    consumer scan cannot see.  When nothing ends up using it, trace-time
    DCE drops it per fetch set — so the collapse is always safe and the
    HBM win materializes exactly when the f32 value is unused.
    Returns the number of collapsed re-casts."""
    block = program.global_block()
    # ONE ordered pass doing rewrite + drop together, so both the drop
    # decision and every consumer rewrite see only definitions that are
    # current at that position (non-SSA safe), and chained collapses
    # resolve transitively at record time.
    castback_src = {}   # f32 name -> half name (current definitions only)
    active = {}         # dropped re-cast output -> surviving half name
    kept = []
    dropped = 0
    for op in block.ops:
        # consumers first: rewrite inputs with the renames active HERE
        for slot, names in op.inputs.items():
            op.inputs[slot] = [active.get(n, n) for n in names]
        if (op.type == "cast" and op.attrs.get("out_dtype") == dtype
                and op.inputs["X"][0] in castback_src):
            src = castback_src[op.inputs["X"][0]]
            out_n = op.outputs["Out"][0]
            # chase chains: src may itself be a dropped re-cast's name
            active[out_n] = active.get(src, src)
            # the drop still REDEFINES out_n: stale cast-back entries
            # keyed by or valued at out_n must not survive it
            castback_src.pop(out_n, None)
            for f32n in [f for f, h in castback_src.items() if h == out_n]:
                castback_src.pop(f32n, None)
            dropped += 1
            continue  # op dropped
        is_castback = (op.type == "cast"
                       and op.attrs.get("out_dtype") == "float32"
                       and op.attrs.get("in_dtype") == dtype)
        for n in op.output_arg_names():
            # any redefinition supersedes earlier renames/cast-backs of n
            active.pop(n, None)
            castback_src.pop(n, None)
            for f32n in [f for f, h in castback_src.items() if h == n]:
                castback_src.pop(f32n, None)
        if is_castback:
            castback_src[op.outputs["Out"][0]] = op.inputs["X"][0]
        kept.append(op)
    if not dropped:
        return 0
    block.ops = kept
    program._bump_version()
    return dropped


def rewrite_fp16(program=None, ops=_BF16_OPS):
    """float16 inference rewrite (paddle/contrib/float16 transpiler
    parity): same cast insertion with IEEE fp16.  Prefer bf16 for
    training (fp16's 5-bit exponent underflows grads)."""
    return rewrite_bf16(program, ops, dtype="float16")
