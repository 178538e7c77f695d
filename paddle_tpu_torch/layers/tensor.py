"""Tensor-building layers (the counterpart of
``paddle_tpu/layers/tensor.py``): the builders the serving and training slices call."""

import numpy as np

from .. import framework
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "create_global_var", "assign", "cast",
           "fill_constant", "concat"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..initializer import Constant

    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(dtype=dtype, shape=shape,
                                        persistable=persistable, name=name)
    helper.set_variable_initializer(var, Constant(value))
    return var


def assign(input, output=None):
    if not isinstance(input, framework.Variable):
        raise NotImplementedError(
            "assign from a host value (assign_value) is not ported yet")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": [input]}, outputs={"Out": [output]})
    return output


def cast(x, dtype):
    if not isinstance(dtype, str):
        dtype = np.dtype(dtype).name
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op("concat", inputs={"X": input}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out
