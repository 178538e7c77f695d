"""matmul_swiglu: silu(x @ wg) * (x @ wu) over x [M, K], wg/wu [K, N],
both projections against one resident x tile, the gate product applied
to the float32 accumulators before the single store.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``matmul_swiglu`` (call
``_swiglu_call``, kernel body ``_swiglu_kernel``); the CUDA kernel is
the gated form of ``csrc/matmul_bias_act.cu``'s tiled GEMM (entry point
``ptt_matmul_swiglu``).  ``matmul_swiglu_plain`` is the plain PyTorch
version (the reference's ``_swiglu_dense``): CPU and meta tensors take
it, CUDA tensors launch the kernel.

``matmul_swiglu`` is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``): the forward launches the kernel, the backward is
the dense recompute of the reference's ``_swiglu_vjp_bwd`` (its
``jax.vjp(_swiglu_dense)``): g = x wg, u = x wu, s = sigmoid(g), then
du = dy g s, dg = dy u s (1 + g (1 - s)), dx = dg wg^T + du wu^T,
dwg = x^T dg, dwu = x^T du.  The JAX package has no backward kernel for
it either.
"""

import torch

from . import build
from .matmul_epilogue import check_extent, mm_plan

__all__ = ["matmul_swiglu", "matmul_swiglu_plain"]


def matmul_swiglu_plain(x2d, wg, wu):
    g = torch.matmul(x2d.float(), wg.float())
    u = torch.matmul(x2d.float(), wu.float())
    return (g * torch.sigmoid(g) * u).to(x2d.dtype)


def _swiglu_forward(x2d, wg, wu):
    if not build.use_kernel(x2d):
        return matmul_swiglu_plain(x2d, wg, wu)
    build.check_inputs("matmul_swiglu", x2d, wg, wu)
    M, K = x2d.shape
    if wg.dim() != 2 or wg.shape[0] != K or wu.shape != wg.shape:
        raise ValueError("matmul_swiglu: shapes x %s, wg %s, wu %s" % (
            tuple(x2d.shape), tuple(wg.shape), tuple(wu.shape)))
    N = wg.shape[1]
    plan = mm_plan(M, N, K, gated=True)
    check_extent("matmul_swiglu", M, N, K, plan)
    out = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    build.launch("ptt_matmul_swiglu", x2d, wg, wu, out, M, N, K, *plan)
    matmul_swiglu.launches += 1
    return out


class _MatmulSwiglu(torch.autograd.Function):
    @staticmethod
    def forward(x2d, wg, wu):
        return _swiglu_forward(x2d, wg, wu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x2d, wg, wu = ctx.saved_tensors
        xf, wgf, wuf = x2d.float(), wg.float(), wu.float()
        g = torch.matmul(xf, wgf)
        u = torch.matmul(xf, wuf)
        s = torch.sigmoid(g)
        dyf = dy.float()
        du = dyf * g * s
        dg = dyf * u * s * (1.0 + g * (1.0 - s))
        dx = torch.matmul(dg, wgf.t()) + torch.matmul(du, wuf.t())
        return (dx.to(x2d.dtype), torch.matmul(xf.t(), dg).to(wg.dtype),
                torch.matmul(xf.t(), du).to(wu.dtype))


def matmul_swiglu(x2d, wg, wu):
    """silu(x2d @ wg) * (x2d @ wu), wg and wu [K, N].  Differentiable in
    all three (dense backward)."""
    return _MatmulSwiglu.apply(x2d, wg, wu)


matmul_swiglu.launches = 0
