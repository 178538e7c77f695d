"""Shared helpers for op lowerings (the counterpart of
``paddle_tpu/ops/common.py``).

Dtype policy: the reference runs int64 as int32 and float64 as float32
on the TPU.  PyTorch on the GPU has fast int64 indexing, so here int64
stays int64 (feeds, ids, positions); float64 still maps to float32.
"""

import numpy as np
import torch

_DTYPE_MAP = {
    "float64": torch.float32,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}

# Paddle framework.proto VarType ids for scripts that pass numeric dtypes
_PROTO_DTYPE = {0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
                5: "float32", 6: "float64", 19: "uint8", 20: "int8",
                21: "bfloat16"}


def tdt(dtype):
    """attr dtype (string / numpy / proto int / torch) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, (int, np.integer)):
        dtype = _PROTO_DTYPE[int(dtype)]
    if not isinstance(dtype, str):
        dtype = np.dtype(dtype).name
    return _DTYPE_MAP[dtype]


def bcast_y(x, y, axis):
    """Paddle elementwise broadcast: Y's shape aligns to X starting at
    `axis` (-1 = trailing); reshape y so broadcasting applies."""
    if x.dim() == y.dim():
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    shape = [1] * axis + list(y.shape) + [1] * (x.dim() - axis - y.dim())
    return y.reshape(shape)
