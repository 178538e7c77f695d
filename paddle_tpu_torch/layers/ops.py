"""The generated unary layers (the counterpart of
``paddle_tpu/layers/ops.py``): one layer per activation-style op, each
appending its op with the caller's keyword arguments as attrs.  The six
that ``layers/nn.py`` already defines with ``**kwargs`` (``tanh``,
``sigmoid``, ``log``, ``square``, ``sqrt``, ``sign``) are those
functions, re-exported."""

from ..layer_helper import LayerHelper
from .nn import log, sigmoid, sign, sqrt, square, tanh  # noqa: F401

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "sqrt", "rsqrt",
    "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal", "square",
    "softplus", "softsign", "brelu", "soft_relu", "stanh", "hard_shrink",
    "thresholded_relu", "selu", "log", "sign", "erf", "gelu",
]

__all__ = list(_UNARY_OPS)


def _make(op_type):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                         attrs=kwargs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = "autogenerated layer for op `%s`" % op_type
    return layer


for _op in _UNARY_OPS:
    if _op not in globals():
        globals()[_op] = _make(_op)
