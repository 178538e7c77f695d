"""Parameter initializers (the counterpart of
``paddle_tpu/initializer.py``).  Each appends an init op to the startup
program; running the startup program materializes the parameters in
the scope.  Random inits draw from seeded ``torch.Generator``s.
"""

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "NumpyArrayInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant", outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random", outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random", outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) > 2:
        rf = int(np.prod(shape[2:]))
        return shape[1] * rf, shape[0] * rf
    n = int(np.prod(shape))
    return n, n


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        return NormalInitializer(0.0, math.sqrt(2.0 / (fi + fo)),
                                 self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """Initialize from a host array (an ``assign_value`` op carrying the
    values), e.g. the Transformer's sinusoid position tables."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            "assign_value", outputs={"Out": [var]},
            attrs={"shape": list(self.value.shape),
                   "values": self.value.flatten().tolist(),
                   "np_dtype": str(self.value.dtype)})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
