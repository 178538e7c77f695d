"""Operator overloading on Variables (the counterpart of
``paddle_tpu/layers/math_op_patch.py``): ``var * 2.0``, ``step ** -0.5``,
``seg > 0`` and the like append the ops the reference appends — a
``scale`` for a scalar add/sub/mul/div, else an elementwise or compare
op (a bool Out) against a ``fill_constant``."""

import numpy as np

from ..layer_helper import LayerHelper


_COMPARE = ("less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal")


def scale(var, scale_val=1.0, bias=0.0):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(var.dtype)
    helper.append_op("scale", inputs={"X": [var]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale_val), "bias": float(bias)})
    return out


def _scalar_elementwise(var, op, scalar, reverse):
    if op == "elementwise_add":
        return scale(var, 1.0, scalar)
    if op == "elementwise_sub":
        return scale(var, -1.0, scalar) if reverse else scale(var, 1.0, -scalar)
    if op == "elementwise_mul":
        return scale(var, scalar, 0.0)
    if op == "elementwise_div" and not reverse:
        return scale(var, 1.0 / scalar, 0.0)
    return None


def binary(var, other, op, reverse=False):
    helper = LayerHelper(op)
    if isinstance(other, (np.integer, np.floating)):
        other = float(other)
    if isinstance(other, (int, float)):
        out = _scalar_elementwise(var, op, float(other), reverse)
        if out is not None:
            return out
        from . import tensor as tensor_layers

        other = tensor_layers.fill_constant([1], var.dtype, float(other))
    x, y = (other, var) if reverse else (var, other)
    out = helper.create_variable_for_type_inference(
        "bool" if op in _COMPARE else var.dtype)
    helper.append_op(op, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs={"axis": -1})
    return out
