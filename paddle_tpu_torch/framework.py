"""Core IR: Program / Block / Operator / Variable / Parameter (the
counterpart of ``paddle_tpu/framework.py``).

A ``Program`` is a list of ``Block``s, each holding ``Variable``s and a
sequence of ``Operator``s (type + named input/output var lists +
attrs).  Var names and op slot names are the reference package's own,
so a program built here lists the same ops over the same names as one
built there.  The executor (``executor.py``) runs a block eagerly, op
by op, through the PyTorch lowerings in ``ops/``.

Serialization is the reference's JSON (``Program.to_json`` /
``from_json``, ndarray attrs as ``{"__ndarray__": ..., "dtype": ...}``),
so a program written by either package loads in the other.
"""

import collections
import contextlib
import copy
import json

import numpy as np
import torch

from . import unique_name

__all__ = [
    "VarType",
    "Program",
    "Block",
    "Operator",
    "Variable",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "grad_var_name",
    "backward_slice_keep",
    "name_scope",
    "cpu_places",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(var_name):
    return var_name + GRAD_VAR_SUFFIX


class VarType:
    """The reference's VarType names (framework.proto:105), as strings."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    STEP_SCOPES = "step_scopes"
    READER = "reader"
    RAW = "raw"


def _to_dtype_str(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if dtype == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


class Variable:
    """A named tensor slot in a Block (VarDesc analog)."""

    def __init__(self, block, name=None, shape=None, dtype=None, lod_level=0,
                 persistable=False, stop_gradient=False,
                 type=VarType.LOD_TENSOR, is_data=False, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = _to_dtype_str(dtype) if dtype is not None else "float32"
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
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

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "is_data": self.is_data,
        }


class Parameter(Variable):
    """A persistable, trainable Variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs["persistable"] = True
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr",
                                        {"learning_rate": 1.0})
        # read by regularizer.append_regularization_ops and
        # clip.append_gradient_clip_ops
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)

    def to_dict(self):
        d = super().to_dict()
        d["is_parameter"] = True
        d["trainable"] = self.trainable
        d["optimize_attr"] = _serializable_optimize_attr(self.optimize_attr)
        return d


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

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name):
        return self.attrs[name]

    def __repr__(self):
        return "Op(type=%s, inputs=%s, outputs=%s)" % (
            self.type, self.inputs, self.outputs)

    def to_dict(self):
        """The reference's OpDesc dict: ndarray attrs as
        {"__ndarray__": list, "dtype": str}, numpy scalars as Python's."""
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            elif isinstance(v, np.integer):
                attrs[k] = int(v)
            elif isinstance(v, np.floating):
                attrs[k] = float(v)
            else:
                attrs[k] = v
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": attrs}


def _serializable_optimize_attr(attr):
    """A Variable in optimize_attr (a per-parameter learning-rate var)
    as a {"__var__": name} marker, so to_json stays JSON."""
    if not attr:
        return attr
    return {k: {"__var__": v.name} if isinstance(v, Variable) else v
            for k, v in attr.items()}


def _resolve_optimize_attr(attr, block):
    """Inverse of _serializable_optimize_attr: a marker resolves to the
    block's Variable, or stays a marker where that var was pruned."""
    if not attr:
        return attr
    out = {}
    for k, v in attr.items():
        if isinstance(v, dict) and set(v) == {"__var__"}:
            resolved = block._find_var_recursive(v["__var__"])
            out[k] = resolved if resolved is not None else v
        else:
            out[k] = v
    return out


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

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.insert_op(0, type, inputs, outputs, attrs)

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """ProgramDesc analog.  ``_version`` keys the executor's plan cache."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._seed = 0
        self._version = 0
        self._is_test = False
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

    def create_block(self, parent_idx=None):
        """A new block under `parent_idx` (default: the current block),
        which becomes the current block."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, len(self.blocks), parent))
        self.current_block_idx = len(self.blocks) - 1
        self._bump_version()
        return self.current_block()

    def rollback(self):
        """Back to the current block's parent."""
        self.current_block_idx = self.current_block().parent_idx

    @property
    def num_blocks(self):
        return len(self.blocks)

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    # ---- cloning / pruning ---------------------------------------------
    def clone(self, for_test=False):
        """A deep copy; with for_test every op's is_test attr (and every
        dropout's and batch_norm's) set True.  A program stamped by
        parallel.annotate_spmd shares its stamp with the copy: the stamp
        holds process groups, which are not copied."""
        memo = {}
        spmd = getattr(self, "_spmd", None)
        if spmd is not None:
            memo[id(spmd)] = spmd
        p = copy.deepcopy(self, memo)
        if for_test:
            p._is_test = True
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                    if op.type in ("dropout", "batch_norm"):
                        op.attrs["is_test"] = True
        p._bump_version()
        return p

    def _prune(self, targets):
        """A copy holding only the global block's ancestor ops of
        `targets` (prune.cc's reverse walk); every var stays."""
        target_names = set(t.name if isinstance(t, Variable) else t
                           for t in _as_list(targets))
        keep = backward_slice_keep(self, target_names)
        p = self.clone()
        pb = p.global_block()
        pb.ops = [op for i, op in enumerate(pb.ops) if keep[i]]
        p._bump_version()
        return p

    # ---- serialization --------------------------------------------------
    def to_json(self):
        return json.dumps({
            "version": 1,
            "random_seed": self._seed,
            "blocks": [b.to_dict() for b in self.blocks],
        })

    @staticmethod
    def from_json(text):
        data = json.loads(text)
        prog = Program()
        prog._seed = data.get("random_seed", 0)
        prog.blocks = []
        for bd in data["blocks"]:
            blk = Block(prog, bd["idx"], bd.get("parent_idx", -1))
            prog.blocks.append(blk)
            for vd in bd["vars"]:
                is_param = vd.pop("is_parameter", False)
                trainable = vd.pop("trainable", True)
                optimize_attr = vd.pop("optimize_attr", None)
                name = vd.pop("name")
                shape = vd.pop("shape")
                if is_param:
                    p = Parameter(blk, shape, vd.pop("dtype"), name=name, **vd)
                    p.trainable = trainable
                    if optimize_attr is not None:
                        p.optimize_attr = optimize_attr
                    blk.vars[name] = p
                else:
                    blk.create_var(name=name, shape=shape, **vd)
            for v in blk.vars.values():
                if isinstance(v, Parameter):
                    v.optimize_attr = _resolve_optimize_attr(
                        v.optimize_attr, blk)
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    else:
                        attrs[k] = v
                op = Operator(blk, od["type"], None, None, attrs)
                op.inputs = {k: list(v) for k, v in od["inputs"].items()}
                op.outputs = {k: list(v) for k, v in od["outputs"].items()}
                blk.ops.append(op)
        prog.current_block_idx = 0
        return prog

    def __str__(self):
        lines = []
        for b in self.blocks:
            lines.append("-- block %d (parent %d) --" % (b.idx, b.parent_idx))
            lines.extend("  " + str(op) for op in b.ops)
        return "\n".join(lines)


def backward_slice_keep(program, target_names):
    """Keep-mask of the global block's ancestor ops of `target_names`
    (prune.cc's reverse walk), behind Program._prune and the inference
    transpiler's fetch cut.  The reference also counts the external
    reads of a kept op's sub-blocks; the port has no op that owns a
    sub-block yet (control flow is ROADMAP A6c), so one raises."""
    block = program.global_block()
    needed = set(target_names)
    keep = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if any(n in needed for n in op.output_arg_names()):
            if any(a.startswith("sub_block") for a in op.attrs):
                raise NotImplementedError(
                    "backward_slice_keep: op '%s' owns a sub-block; control "
                    "flow is not ported yet (ROADMAP A6c)" % op.type)
            keep[i] = True
            needed.update(op.input_arg_names())
    return keep


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


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """The reference's name scope: a stack of prefixes that names
    nothing (var and op names are unique_name's)."""
    _name_scope_stack.append(prefix or "")
    try:
        yield
    finally:
        _name_scope_stack.pop()


def cpu_places(device_count=None):
    """`device_count` CPUPlaces (one by default)."""
    from .places import CPUPlace

    return [CPUPlace() for _ in range(device_count or 1)]
