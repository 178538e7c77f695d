"""Core IR: Program / Block / Operator / Variable / Parameter (the
counterpart of ``paddle_tpu/framework.py``).

A ``Program`` is a list of ``Block``s, each holding ``Variable``s and a
sequence of ``Operator``s (type + named input/output var lists +
attrs).  Var names and op slot names are the reference package's own,
so a program built here lists the same ops over the same names as one
built there.  The executor (``executor.py``) runs a block eagerly, op
by op, through the PyTorch lowerings in ``ops/``.
"""

import collections
import contextlib

import numpy as np
import torch

from . import unique_name

__all__ = [
    "Program",
    "Block",
    "Operator",
    "Variable",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "grad_var_name",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(var_name):
    return var_name + GRAD_VAR_SUFFIX


def _to_dtype_str(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if dtype == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


class Variable:
    """A named tensor slot in a Block (VarDesc analog)."""

    def __init__(self, block, name=None, shape=None, dtype=None, lod_level=0,
                 persistable=False, stop_gradient=False, is_data=False,
                 **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = _to_dtype_str(dtype) if dtype is not None else "float32"
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.op = None  # producing op (filled by append_op)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    # numpy-style operators (the reference's math_op_patch): each appends
    # the same op the reference appends (scale for scalar add/sub/mul/div,
    # else an elementwise op against a fill_constant)
    def _binary(self, other, op, reverse=False):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, op, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __rpow__(self, other):
        return self._binary(other, "elementwise_pow", reverse=True)

    def __neg__(self):
        from .layers import math_op_patch

        return math_op_patch.scale(self, -1.0)

    def __lt__(self, other):
        return self._binary(other, "less_than")

    def __le__(self, other):
        return self._binary(other, "less_equal")

    def __gt__(self, other):
        return self._binary(other, "greater_than")

    def __ge__(self, other):
        return self._binary(other, "greater_equal")

    def astype(self, dtype):
        from .layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)


class Parameter(Variable):
    """A persistable, trainable Variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs["persistable"] = True
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr",
                                        {"learning_rate": 1.0})


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Operator:
    """OpDesc analog: type + named input/output variable-name lists + attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {
            slot: [v.name if isinstance(v, Variable) else v
                   for v in _as_list(vs)]
            for slot, vs in (inputs or {}).items()}
        self.outputs = {
            slot: [v.name if isinstance(v, Variable) else v
                   for v in _as_list(vs)]
            for slot, vs in (outputs or {}).items()}
        self.attrs = dict(attrs) if attrs else {}
        if "op_role" not in self.attrs and block is not None:
            prog = block.program
            self.attrs["op_role"] = prog.op_role
            if prog._op_role_var:
                self.attrs["op_role_var"] = list(prog._op_role_var)

    def input_arg_names(self):
        return [n for names in self.inputs.values() for n in names if n]

    def output_arg_names(self):
        return [n for names in self.outputs.values() for n in names if n]

    def __repr__(self):
        return "Op(type=%s, inputs=%s, outputs=%s)" % (
            self.type, self.inputs, self.outputs)


class Block:
    """BlockDesc analog: ordered ops + var table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        param = Parameter(self, kwargs.pop("shape"), kwargs.pop("dtype"),
                          **kwargs)
        gb = self.program.global_block()  # parameters live in the root block
        gb.vars[param.name] = param
        param.block = gb
        return param

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %s not found in block %d"
                             % (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for vs in (outputs or {}).values():
            for v in _as_list(vs):
                if isinstance(v, Variable):
                    v.op = op
        self.program._bump_version()
        return op


class Program:
    """ProgramDesc analog.  ``_version`` keys the executor's plan cache."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._seed = 0
        self._version = 0
        self.op_role = "forward"
        self._op_role_var = []

    def _bump_version(self):
        self._version += 1

    @contextlib.contextmanager
    def _op_role_guard(self, role, role_var=None):
        """Tag the ops appended inside with an op role (and an optional
        op_role_var [param, grad] pair), as the reference does."""
        prev_role, prev_var = self.op_role, self._op_role_var
        self.op_role = role
        self._op_role_var = list(role_var or [])
        try:
            yield
        finally:
            self.op_role, self._op_role_var = prev_role, prev_var

    def _optimized_guard(self, param_and_grad):
        names = [p.name if isinstance(p, Variable) else p
                 for p in param_and_grad if p is not None]
        return self._op_role_guard("optimize", names)

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = int(seed)

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def all_parameters(self):
        return self.global_block().all_parameters()

    def __str__(self):
        lines = []
        for b in self.blocks:
            lines.append("-- block %d (parent %d) --" % (b.idx, b.parent_idx))
            lines.extend("  " + str(op) for op in b.ops)
        return "\n".join(lines)


_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
