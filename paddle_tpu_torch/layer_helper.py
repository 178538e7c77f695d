"""LayerHelper (the counterpart of ``paddle_tpu/layer_helper.py``).

Layers use this to create parameters (with startup-program init ops),
temporary output vars, and to append ops.  Build-time shape inference
runs the op's own PyTorch lowering on ``meta`` tensors, which carry
shape and dtype and allocate nothing — the counterpart of the
reference's ``jax.eval_shape`` over its lowering, so one rule per op
serves both execution and inference.  Unknown batch dims (-1) ride
through as a sentinel extent.

Unlike the reference, an inference failure raises instead of leaving
the output vars unshaped: a silently unshaped var would only surface
later, in a fuse pass that reads shapes.
"""

import copy

import numpy as np
import torch

from . import framework, unique_name
from .core.registry import LowerCtx, get_op, is_registered
from .ops.common import tdt
from .param_attr import ParamAttr

# sentinel for unknown (-1) dims: a large prime no real extent collides
# with (meta tensors allocate nothing, so the size is free)
_DYN = 1000003


def _meta_inputs(op, block):
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or v.shape is None:
                return None
            shape = tuple(_DYN if d in (-1, None) else int(d) for d in v.shape)
            vals.append(torch.empty(shape, dtype=tdt(v.dtype), device="meta"))
        ins[slot] = vals
    return ins


def infer_shape(op, block):
    """Set output var shapes/dtypes from the lowering run on meta tensors."""
    if not is_registered(op.type):
        return
    ins = _meta_inputs(op, block)
    if ins is None:
        return
    try:
        outs = get_op(op.type).lower(LowerCtx(device="meta"), ins, op.attrs)
    except Exception as e:
        raise RuntimeError(
            "shape inference failed for op '%s' with input shapes %s: %s: %s"
            % (op.type, {s: [tuple(t.shape) for t in ts]
                         for s, ts in ins.items()}, type(e).__name__, e)) from e
    for slot, names in op.outputs.items():
        for n, t in zip(names, outs.get(slot) or ()):
            v = block._find_var_recursive(n)
            if v is not None and isinstance(t, torch.Tensor):
                v.shape = tuple(-1 if d == _DYN else int(d) for d in t.shape)
                v.dtype = framework._to_dtype_str(t.dtype)


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if self.kwargs.get("name") is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, framework.Variable):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly one input"
                             % self.layer_type)
        return inputs[0]

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for i in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = i.dtype
            elif dtype != i.dtype:
                raise ValueError("mismatched input dtypes")
        return dtype

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr", None))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [copy.deepcopy(attr) for _ in range(length)]
        return attr

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = copy.deepcopy(attr) if attr is not None else ParamAttr()
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "b" if is_bias else "w"]))
        shape = [int(s) for s in shape]
        param = self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_var(name=param.name, shape=shape,
                                      dtype=dtype, persistable=True)
        attr.initializer(sp, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, shape=None, persistable=False,
            stop_gradient=stop_gradient)

    # the reference's older name, which fluid layer code still calls
    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if not block.has_var_local(name):
            return self.create_global_variable(name=name, *args, **kwargs)
        return block.vars[name]

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        initializer(sv, sb)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        block = self.main_program.current_block()
        op = block.append_op(type, inputs, outputs, attrs)
        infer_shape(op, block)
        return op

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        size = input_var.shape[dim_start:dim_end]
        b = self.create_parameter(attr=bias_attr,
                                  shape=[int(np.prod(size))],
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op("elementwise_add", inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = copy.deepcopy(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp

    def is_instance(self, param_name, cls):
        """Raises TypeError unless the layer's kwarg `param_name` is a
        `cls`."""
        param = self.kwargs.get(param_name, None)
        if not isinstance(param, cls):
            raise TypeError("%s must be %s" % (param_name, cls))
