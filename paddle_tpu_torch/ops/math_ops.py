"""Elementwise / activation / matmul op lowerings (the counterpart of
``paddle_tpu/ops/math_ops.py``), limited to the ops the serving slice
and the GPT-2 logits program run.  ``mul`` and ``matmul`` are plain
products outside any kernel of the reference, so they stay
``torch.matmul`` here too.
"""

import torch

from ..core.registry import register
from .common import bcast_y


def _elementwise(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        out = fn(x, bcast_y(x, y, attrs.get("axis", -1)))
        scale = attrs.get("scale", None)
        if scale is not None and scale != 1.0:
            out = out * scale
        return {"Out": [out]}

    return lower


register("elementwise_add")(_elementwise(torch.add))
register("elementwise_mul")(_elementwise(torch.mul))


@register("gelu")
def _gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(ins["X"][0],
                                             approximate=approximate)]}


def _flatten2(x, ncol):
    lead = 1
    for d in x.shape[:ncol]:
        lead *= d
    return x.reshape(lead, -1)


@register("mul")
def _mul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    out = _flatten2(x, xn) @ _flatten2(y, yn)
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


@register("matmul")
def _matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    tx, ty = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    if x.dim() == 1:
        x = x[None, :] if not tx else x[:, None]
    if y.dim() == 1:
        y = y[:, None] if not ty else y[None, :]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}
