"""Reference-contract compatibility lowerings (the counterpart of
``paddle_tpu/ops/compat_ops.py``), limited to the targets of the
inference predictor's fuse passes: ``gru`` / ``fusion_gru`` and
``lstm`` / ``fusion_lstm`` over ``project_input_maybe``, and
``fused_elemwise_activation``.  The recurrent ops delegate to
``padded_gru`` / ``padded_lstm``, so their forward direction runs the
fused_gru / fused_lstm kernels on CUDA tensors; the in-op projection is
a plain ``torch.matmul``, as the reference's is an XLA dot outside any
kernel.
"""

import torch

from ..core.registry import get_op, register

__all__ = ["project_input_maybe"]


def _delegate(type_, ctx, ins, attrs):
    return get_op(type_).lower(ctx, ins, attrs)


def project_input_maybe(ins):
    """The shared in-op fc of fusion_gru / fusion_lstm /
    fused_embedding_fc_lstm: with WeightX present, Input is the raw
    [B, T, D] sequence, projected here by x @ WeightX (+ BiasX)."""
    if not ins.get("WeightX"):
        return ins
    xproj = torch.matmul(ins["Input"][0], ins["WeightX"][0])
    if ins.get("BiasX"):
        xproj = xproj + ins["BiasX"][0].reshape(1, 1, -1)
    return dict(ins, Input=[xproj])


@register("gru")
@register("fusion_gru")
def _gru(ctx, ins, attrs):
    """gru_op.cc's contract on the padded representation: Input the
    projected gates [B, T, 3H] (fusion_gru: the raw [B, T, D] sequence
    with WeightX [D, 3H]); emits Hidden and LastH."""
    ins = project_input_maybe(ins)
    out = _delegate("padded_gru", ctx, ins, attrs)
    return {"Hidden": out["Hidden"], "LastH": out.get("LastH", [])}


@register("lstm")
@register("fusion_lstm")
def _lstm(ctx, ins, attrs):
    """lstm_op.cc's contract: Input [B, T, 4H] projected gates
    (fusion_lstm: the raw sequence with WeightX) -> Hidden and Cell,
    both [B, T, H] per-step sequences, LastH and LastC."""
    ins = project_input_maybe(ins)
    out = _delegate("padded_lstm", ctx, ins, attrs)
    return {"Hidden": out["Hidden"], "Cell": out["CellSeq"],
            "LastH": out["LastH"], "LastC": out["LastC"]}


@register("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """functor_list [binary, unary] -> Binary(X, Unary(Y)); [unary,
    binary] -> Unary(Binary(X, Y)), the reference's two conventions."""
    x, y = ins["X"][0], ins["Y"][0]
    functors = [str(f) for f in attrs.get("functor_list", [])]
    binary = {
        "elementwise_add": lambda a, b: a + b,
        "elementwise_sub": lambda a, b: a - b,
        "elementwise_mul": lambda a, b: a * b,
    }
    unary = {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "scale": lambda a: a * float(attrs.get("scale", 1.0)),
    }
    if len(functors) != 2:
        raise NotImplementedError(
            "fused_elemwise_activation needs a 2-element functor_list, "
            "got %r" % (functors,))
    f1, f2 = functors
    if f1 in binary and f2 in unary:
        out = binary[f1](x, unary[f2](y))
    elif f1 in unary and f2 in binary:
        out = unary[f1](binary[f2](x, y))
    else:
        raise NotImplementedError(
            "fused functor_list %r (need one binary + one unary of %s / %s)"
            % (functors, sorted(binary), sorted(unary)))
    return {"Out": [out]}
