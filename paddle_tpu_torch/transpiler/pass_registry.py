"""Program pass infrastructure (the counterpart of
``paddle_tpu/transpiler/pass_registry.py``): ``Pass`` /
``register_pass`` / ``get_pass`` / ``list_passes`` / ``apply_pass``, the
``OpPattern`` chain matcher over a block's def-use graph, and the
reference's built-in registrations: the inference passes
(``conv_bn_fuse_pass``, ``bn_fold_pass``, ``is_test_pass``,
``train_prune_pass``), ``memory_optimize_pass``, ``bf16_amp_pass``,
``nhwc_layout_pass``, ``fuse_relu_into_conv_pass`` and
``attention_fuse_pass``.  Three of the reference's passes are not
ported: ``get_pass`` raises its KeyError for them, naming the ROADMAP
item that ports them."""

from ..analysis.graph import consumer_map

__all__ = ["Pass", "register_pass", "get_pass", "list_passes", "apply_pass",
           "OpPattern", "consumer_map"]

_PASSES = {}

# the reference's passes that wait for a module of the port
_NOT_PORTED = {
    "weight_int8_pass": "ROADMAP A6c, contrib/quantize",
    "graph_viz_pass": "ROADMAP A9, debugger",
    "remat_pass": "ROADMAP A9, transpiler/remat",
}


class Pass:
    """Base class: subclasses implement apply(program, scope=None)."""

    name = None

    def apply(self, program, scope=None):
        raise NotImplementedError

    def __call__(self, program, scope=None):
        return self.apply(program, scope=scope)


def register_pass(name):
    """Decorator registering a Pass subclass or a function
    program -> program under `name`."""

    def deco(obj):
        if isinstance(obj, type) and issubclass(obj, Pass):
            inst = obj()
        else:
            inst = Pass()
            inst.apply = lambda program, scope=None, _f=obj: _f(program, scope)
        inst.name = name
        _PASSES[name] = inst
        return obj

    return deco


def get_pass(name):
    if name not in _PASSES:
        hint = (" — not ported yet (%s)" % _NOT_PORTED[name]
                if name in _NOT_PORTED else "")
        raise KeyError("no pass '%s' registered%s (known: %s)"
                       % (name, hint, sorted(_PASSES)))
    return _PASSES[name]


def list_passes():
    return sorted(_PASSES)


def apply_pass(program, name, scope=None):
    """Apply one registered pass; returns the (possibly same) program."""
    out = get_pass(name).apply(program, scope=scope)
    return out if out is not None else program


class OpPattern:
    """A linear chain of op types connected by single-consumer def-use
    edges; ``rewrite`` hands each match to a callback that may mutate
    the block (return True to count a rewrite)."""

    def __init__(self, op_types):
        self.op_types = list(op_types)

    def match(self, block):
        consumers = consumer_map(block)
        for op in block.ops:
            if op.type != self.op_types[0]:
                continue
            chain = [op]
            cur = op
            for want in self.op_types[1:]:
                nxt = None
                for name in cur.output_arg_names():
                    cs = consumers.get(name, [])
                    if len(cs) == 1 and block.ops[cs[0]].type == want:
                        nxt = block.ops[cs[0]]
                        break
                if nxt is None:
                    break
                chain.append(nxt)
                cur = nxt
            if len(chain) == len(self.op_types):
                yield chain

    def rewrite(self, block, fn):
        """Apply fn to every match, re-scanning after each mutation; a
        chain already offered is never offered again."""
        count = 0
        seen = set()
        changed = True
        while changed:
            changed = False
            for chain in self.match(block):
                key = tuple(id(op) for op in chain)
                if key in seen:
                    continue
                seen.add(key)
                if fn(chain):
                    count += 1
                    changed = True
                    break
        return count


# ---------------------------------------------------------------------------
# built-in registrations (the reference's PassBuilder pipeline)
# ---------------------------------------------------------------------------
@register_pass("conv_bn_fuse_pass")
def _conv_bn_fuse(program, scope):
    """The name the predictor's fold_batch_norm resolves to: one
    implementation with bn_fold_pass."""
    return _bn_fold(program, scope)


@register_pass("is_test_pass")
def _is_test(program, scope):
    from .inference_transpiler import InferenceTranspiler

    InferenceTranspiler()._drop_train_ops(program)
    return program


@register_pass("bn_fold_pass")
def _bn_fold(program, scope):
    """Batch-norm (and a pure scale link) folded into the preceding
    conv2d / depthwise_conv2d / fc / mul's weights and bias in the
    scope."""
    from .inference_transpiler import InferenceTranspiler

    if scope is None:
        raise ValueError(
            "bn_fold_pass folds BN statistics into producer weights and "
            "needs the scope holding them: apply_pass(prog, "
            "'bn_fold_pass', scope=...)")
    InferenceTranspiler()._fold_batch_norm(program, scope)
    return program


@register_pass("train_prune_pass")
def _train_prune(program, scope):
    """Train-only ops dropped (dropout to its is_test form) and, where
    the program carries _protected_fetch_names, everything below that
    cut sliced away."""
    from .inference_transpiler import InferenceTranspiler

    t = InferenceTranspiler()
    t._drop_train_ops(program)
    t._prune_to_fetches(program)
    return program


@register_pass("memory_optimize_pass")
def _memory_optimize(program, scope):
    from .memory_optimization_transpiler import memory_optimize

    memory_optimize(program)
    return program


@register_pass("bf16_amp_pass")
def _bf16_amp(program, scope):
    from ..contrib.mixed_precision import rewrite_bf16

    rewrite_bf16(program)
    return program


@register_pass("nhwc_layout_pass")
def _nhwc_layout(program, scope):
    from .layout_transpiler import rewrite_nhwc

    rewrite_nhwc(program)
    return program


@register_pass("fuse_relu_into_conv_pass")
class FuseReluIntoConv(Pass):
    """conv2d followed by a single-consumer relu becomes conv2d with the
    fuse_relu epilogue."""

    def apply(self, program, scope=None):
        block = program.global_block()

        def fuse(chain):
            conv, relu = chain
            conv.outputs["Output"] = [relu.outputs["Out"][0]]
            conv.attrs["fuse_relu"] = True
            block.ops.remove(relu)
            program._bump_version()
            return True

        OpPattern(["conv2d", "relu"]).rewrite(block, fuse)
        return program


@register_pass("attention_fuse_pass")
class AttentionFusePass(Pass):
    """matmul(Q, K, transpose_Y, alpha) [-> elementwise_add(rank-1 key
    bias)] -> softmax [-> dropout(is_test)] -> matmul(weights, V)
    becomes ONE fused_attention op (on the flash attention kernel); a
    downgrade_in_infer dropout's (1 - p) becomes a scale op after it,
    the fused op writing `<out>@ATTN_RAW`.  Conditions, as the
    reference's: Q, K and V rank 4 with Q's batch, heads and head width,
    K and V of one length; the bias [B or -1, 1, 1, Tk]; softmax over
    the last axis; an is_test dropout only.  Records
    _attention_fused_count."""

    def apply(self, program, scope=None):
        from .. import framework as _fw

        block = program.global_block()

        def fuse(chain):
            m1, m2 = chain[0], chain[-1]
            mid = chain[1:-1]
            add = next((o for o in mid if o.type == "elementwise_add"), None)
            sm = next((o for o in mid if o.type == "softmax"), None)
            drop = next((o for o in mid if o.type == "dropout"), None)
            if sm is None:
                return False
            if not m1.attrs.get("transpose_Y", False) or m1.attrs.get(
                    "transpose_X", False):
                return False
            if m2.attrs.get("transpose_X") or m2.attrs.get("transpose_Y"):
                return False
            # the probabilities must be matmul2's LHS (weights @ V)
            prob_name = (drop or sm).outputs["Out"][0]
            if m2.inputs.get("X", [None])[0] != prob_name:
                return False
            if sm.attrs.get("axis", -1) not in (-1,):
                return False
            if drop is not None and not drop.attrs.get("is_test", False):
                return False
            post_scale = 1.0
            if drop is not None and drop.attrs.get(
                    "dropout_implementation",
                    "downgrade_in_infer") == "downgrade_in_infer":
                post_scale = 1.0 - float(drop.attrs.get("dropout_prob", 0.0))
            qvar = block._find_var_recursive(m1.inputs["X"][0])
            kvar = block._find_var_recursive(m1.inputs["Y"][0])
            vvar = block._find_var_recursive(m2.inputs["Y"][0])
            if any(v is None or v.shape is None or len(v.shape) != 4
                   for v in (qvar, kvar, vvar)):
                return False

            def _dim(v, i):
                return int(v.shape[i])

            # K/V share Q's batch, heads and head width, and one length
            if (_dim(kvar, 0) != _dim(qvar, 0)
                    or _dim(vvar, 0) != _dim(qvar, 0)
                    or _dim(kvar, 1) != _dim(qvar, 1)
                    or _dim(vvar, 1) != _dim(qvar, 1)
                    or _dim(kvar, 3) != _dim(qvar, 3)
                    or _dim(vvar, 3) != _dim(qvar, 3)
                    or (_dim(kvar, 2) != -1 and _dim(vvar, 2) != -1
                        and _dim(kvar, 2) != _dim(vvar, 2))):
                return False
            inputs = {"Q": m1.inputs["X"], "K": m1.inputs["Y"],
                      "V": m2.inputs["Y"]}
            if add is not None:
                # the bias is the add operand that is NOT the QK^T product
                prod_name = m1.outputs["Out"][0]
                add_ins = add.inputs.get("X", []) + add.inputs.get("Y", [])
                others = [n for n in add_ins if n != prod_name]
                if prod_name not in add_ins or len(others) != 1:
                    return False
                bname = others[0]
                bvar = block._find_var_recursive(bname)
                # reshapeable to [B, Tk]: [B or -1, 1, 1, Tk] only
                if (bvar is None or bvar.shape is None
                        or len(bvar.shape) != 4
                        or int(bvar.shape[1]) != 1
                        or int(bvar.shape[2]) != 1
                        or (int(bvar.shape[0]) not in (-1,)
                            and int(bvar.shape[0]) != int(qvar.shape[0]))
                        or (int(bvar.shape[3]) != -1 and _dim(kvar, 2) != -1
                            and int(bvar.shape[3]) != _dim(kvar, 2))):
                    return False
                inputs["Bias"] = [bname]
            fused = _fw.Operator(block, "fused_attention", None, None,
                                 {"causal": False,
                                  "scale": float(m1.attrs.get("alpha", 1.0))})
            fused.inputs = inputs
            out_name = m2.outputs["Out"][0]
            # where the SECOND matmul sat: every fused input is defined
            idx = block.ops.index(m2) - (len(chain) - 1)
            new_ops = [fused]
            if post_scale != 1.0:
                raw = out_name + "@ATTN_RAW"
                ov = block._find_var_recursive(out_name)
                block.create_var(
                    name=raw,
                    shape=list(ov.shape) if ov is not None and ov.shape
                    else None,
                    dtype=ov.dtype if ov is not None else "float32")
                fused.outputs = {"Out": [raw]}
                scale_op = _fw.Operator(
                    block, "scale", None, None,
                    {"scale": post_scale, "bias": 0.0,
                     "bias_after_scale": True})
                scale_op.inputs = {"X": [raw]}
                scale_op.outputs = {"Out": [out_name]}
                new_ops.append(scale_op)
            else:
                fused.outputs = {"Out": [out_name]}
            for op in chain:
                block.ops.remove(op)
            for j, op in enumerate(new_ops):
                block.ops.insert(idx + j, op)
            program._bump_version()
            return True

        n = 0
        for pat in (
                ["matmul", "elementwise_add", "softmax", "dropout", "matmul"],
                ["matmul", "elementwise_add", "softmax", "matmul"],
                ["matmul", "softmax", "dropout", "matmul"],
                ["matmul", "softmax", "matmul"]):
            n += OpPattern(pat).rewrite(block, fuse)
        program._attention_fused_count = n
        return program
