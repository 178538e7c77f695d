"""fused_add_layer_norm: residual add + row LayerNorm in one pass.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``fused_add_layer_norm``
(kernel body ``_add_ln_kernel``); the CUDA kernel is
``csrc/add_layer_norm.cu``.  ``add_layer_norm_plain`` is the plain
PyTorch version (the reference's ``_add_ln_dense``): CPU and meta
tensors take it, CUDA tensors launch the kernel.

Beside the reference's (sum, normalized) pair, both return each row's
float32 mean and variance: the ``fused_residual_ln`` op outputs them,
and the kernel has them in hand already.  They take no gradient (the
reference stops it).

``fused_add_layer_norm`` is a ``torch.autograd.Function`` (the
reference's ``jax.custom_vjp``): the forward launches the kernel, the
backward is the dense recompute of the reference's ``_add_ln_vjp_bwd``
(the statistics of s = x + y again, then the LayerNorm vjp).  The JAX
package has no backward kernel for it either.
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


def _add_ln_forward(x2d, y2d, gamma, beta, eps):
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


class _AddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(x2d, y2d, gamma, beta, eps):
        return _add_ln_forward(x2d, y2d, gamma, beta, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, y2d, gamma, beta, eps = inputs
        ctx.save_for_backward(x2d, y2d, gamma)
        ctx.eps = eps
        ctx.mark_non_differentiable(output[2], output[3])

    @staticmethod
    def backward(ctx, ds, dout, _dmean, _dvar):
        x2d, y2d, gamma = ctx.saved_tensors
        s = x2d.float() + y2d.float()
        mean = s.mean(-1, keepdim=True)
        rstd = torch.rsqrt((s - mean).square().mean(-1, keepdim=True)
                           + ctx.eps)
        xhat = (s - mean) * rstd
        dout = dout.float()
        dgamma = (dout * xhat).sum(0)
        dbeta = dout.sum(0)
        dxhat = dout * gamma.float()
        dsum = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                       - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        dsum = dsum + ds.float()
        return (dsum.to(x2d.dtype), dsum.to(y2d.dtype),
                dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None)


def fused_add_layer_norm(x2d, y2d, gamma, beta, eps=1e-5):
    """(s, LayerNorm(s) * gamma + beta, mean, variance) with s = x2d + y2d,
    over [R, H] rows; gamma and beta are [H], mean and variance [R].
    Differentiable in x2d, y2d, gamma and beta through s and the
    normalized rows (dense backward)."""
    return _AddLayerNorm.apply(x2d, y2d, gamma, beta, float(eps))


fused_add_layer_norm.launches = 0
