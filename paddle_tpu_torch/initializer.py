"""Parameter initializers (the counterpart of
``paddle_tpu/initializer.py``).  Each appends an init op to the startup
program; running the startup program materializes the parameters in
the scope.  Random inits draw from seeded ``torch.Generator``s.
"""

import contextlib
import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "Bilinear", "NumpyArrayInitializer", "force_init_on_cpu",
           "init_on_cpu"]


def force_init_on_cpu():
    """False: the executor places every initialized var, as the
    reference's does."""
    return False


@contextlib.contextmanager
def init_on_cpu():
    """The reference's no-op context: the executor owns placement, so the
    initializers under it append the same ops."""
    yield


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


class TruncatedNormalInitializer(Initializer):
    """A normal draw truncated to two standard deviations about the mean
    (the ``truncated_gaussian_random`` op)."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random", outputs={"Out": [var]},
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


class MSRAInitializer(Initializer):
    """He initialization from the fan in: uniform in +- sqrt(6 / fan_in),
    or normal with std sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        return NormalInitializer(0.0, math.sqrt(2.0 / fi),
                                 self.seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel of a 4-D [C_out, C_in, H, W] filter
    (conv2d_transpose upsampling), as the values of an assign_value op."""

    def __call__(self, var, block):
        shape = var.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        size = int(np.prod(shape))
        flat = np.zeros(size, dtype="float32")
        for i in range(size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return NumpyArrayInitializer(flat.reshape(shape))(var, block)


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
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
