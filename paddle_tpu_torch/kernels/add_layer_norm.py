"""fused_add_layer_norm: residual add + row LayerNorm in one pass.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``fused_add_layer_norm``
(kernel body ``_add_ln_kernel``); the CUDA kernel is
``csrc/add_layer_norm.cu``.  ``add_layer_norm_plain`` is the plain
PyTorch version (the reference's ``_add_ln_dense``): CPU and meta
tensors take it, CUDA tensors launch the kernel.

Beside the reference's (sum, normalized) pair, both return each row's
float32 mean and variance: the ``fused_residual_ln`` op outputs them,
and the kernel has them in hand already.
"""

import torch

from . import build

__all__ = ["fused_add_layer_norm", "add_layer_norm_plain"]


def add_layer_norm_plain(x2d, y2d, gamma, beta, eps=1e-5):
    s = x2d.float() + y2d.float()
    mean = s.mean(-1, keepdim=True)
    var = (s - mean).square().mean(-1, keepdim=True)
    yn = (s - mean) * torch.rsqrt(var + eps)
    return (s.to(x2d.dtype), (yn * gamma + beta).to(x2d.dtype),
            mean.reshape(-1), var.reshape(-1))


def fused_add_layer_norm(x2d, y2d, gamma, beta, eps=1e-5):
    """(s, LayerNorm(s) * gamma + beta, mean, variance) with s = x2d + y2d,
    over [R, H] rows; gamma and beta are [H], mean and variance [R]."""
    if not build.use_kernel(x2d):
        return add_layer_norm_plain(x2d, y2d, gamma, beta, eps)
    build.check_inputs("fused_add_layer_norm", x2d, y2d, gamma, beta)
    R, H = x2d.shape
    if tuple(y2d.shape) != (R, H) or gamma.numel() != H or beta.numel() != H:
        raise ValueError("fused_add_layer_norm: shapes %s %s %s %s" % (
            tuple(x2d.shape), tuple(y2d.shape), tuple(gamma.shape),
            tuple(beta.shape)))
    if H * 4 > 48 * 1024 or R >= 2 ** 31:
        raise ValueError("fused_add_layer_norm: row of %d floats exceeds the "
                         "kernel's 48 KB shared-memory row buffer" % H)
    s = torch.empty_like(x2d)
    out = torch.empty_like(x2d)
    mean = torch.empty(R, dtype=torch.float32, device=x2d.device)
    var = torch.empty(R, dtype=torch.float32, device=x2d.device)
    build.launch("ptt_add_layer_norm", x2d, y2d, gamma, beta, s, out, mean,
                 var, R, H, float(eps))
    fused_add_layer_norm.launches += 1
    return s, out, mean, var


fused_add_layer_norm.launches = 0
