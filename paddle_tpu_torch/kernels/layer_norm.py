"""fused_layer_norm: row LayerNorm in one pass.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``fused_layer_norm``
(``_ln_fwd``, kernel body ``_ln_kernel``); the CUDA kernel is
``csrc/layer_norm.cu``.  ``layer_norm_plain`` is the plain PyTorch
version (the reference's ``_ln_dense``): CPU and meta tensors take it,
CUDA tensors launch the kernel.

Beside the normalized rows, both return each row's float32 mean and
variance: the ``layer_norm`` op outputs them, and the kernel has them in
hand already.  They take no gradient (the reference stops it).

``fused_layer_norm`` is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``): the forward launches the kernel, the backward is
the dense form of the reference's ``_ln_vjp_bwd``, from the row
statistics the forward saved.  The JAX package has no backward kernel
for it either.

``ln_plan`` picks the kernel's form: one warp per row with the row in
registers up to ``WARP_MAX_H``, as many rows a block as keep every SM
busy; one block per row with the row in shared memory beyond.

bf16: a bfloat16 x (and float32 gamma and beta, which the AMP trunk pass
keeps float32) launches the kernel's bf16 form on the same plan: float32
statistics, the output rounded once to bfloat16, 16-byte loads of 8
columns where H % 8 == 0.  The backward is the reference's ``jax.vjp``
of ``_ln_dense`` in dtype: float32 arithmetic, dx rounded to x's dtype,
dgamma and dbeta float32.
"""

import collections

import torch

from . import build

__all__ = ["fused_layer_norm", "fused_layer_norm_bf16", "layer_norm_plain",
           "ln_plan"]

WARP, BLOCK = 0, 1  # the plan's forms
# the register form's widest row (8 float4 a lane): on the card it beat
# the block form at H 768 at every row count and lost at H 2048 at every
# one (scripts/decode_kernels_check.py)
WARP_MAX_H = 1024
BLOCK_MAX_H = 48 * 1024 // 4  # the block form's shared-memory row buffer
N4_SLOTS = (1, 2, 4, 6, 8)  # the register form's instantiations
MAX_ROWS = 8  # rows (warps) a block of the register form
# the H100 SXM's SMs, as matmul_epilogue's plans take them: on another
# card only the rows a block shift, never a row's result (each row is one
# warp's alone)
SMS = 132

LnPlan = collections.namedtuple("LnPlan", "form n4 vec rows")


def ln_plan(R, H):
    """The kernel's form for [R, H] rows.  H <= WARP_MAX_H: (WARP, n4,
    vec, rows), n4 float4 slots a lane (the least instantiated count with
    128 n4 >= H), float4 access where H % 4 == 0, and the most rows a
    block (up to MAX_ROWS) that still gives every SM a block; else
    (BLOCK, 0, 0, 0).  Raises where neither form takes the shape."""
    if H > BLOCK_MAX_H or R >= 2 ** 31:
        raise build.KernelInputError("fused_layer_norm: [%d, %d] exceeds the "
                                     "kernel's 48 KB shared-memory row buffer "
                                     "or 32-bit rows" % (R, H))
    if H > WARP_MAX_H:
        return LnPlan(BLOCK, 0, 0, 0)
    need = -(-H // 128)
    return LnPlan(WARP, next(n for n in N4_SLOTS if n >= need),
                  int(H % 4 == 0), max(1, min(MAX_ROWS, R // SMS)))


def layer_norm_plain(x2d, gamma, beta, eps=1e-5):
    x = x2d.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return ((y * gamma + beta).to(x2d.dtype), mean.reshape(-1),
            var.reshape(-1))


def _ln_forward(x2d, gamma, beta, eps):
    if not build.use_kernel(x2d):
        return layer_norm_plain(x2d, gamma, beta, eps)
    build.check_inputs("fused_layer_norm", x2d, gamma, beta)
    R, H = x2d.shape
    if gamma.numel() != H or beta.numel() != H:
        raise build.KernelInputError("fused_layer_norm: shapes %s %s %s" % (
            tuple(x2d.shape), tuple(gamma.shape), tuple(beta.shape)))
    plan = ln_plan(R, H)
    out = torch.empty_like(x2d)
    mean = torch.empty(R, dtype=torch.float32, device=x2d.device)
    var = torch.empty(R, dtype=torch.float32, device=x2d.device)
    # 16-byte access needs 16-byte aligned rows (a view may start
    # anywhere): 4 float32 columns, or 8 bfloat16 ones (H % 8 == 0)
    bf16 = x2d.dtype == torch.bfloat16
    vec = plan.vec and (not bf16 or H % 8 == 0) and all(
        t.data_ptr() % 16 == 0 for t in (x2d, gamma, beta, out))
    build.launch("ptt_layer_norm_bf16" if bf16 else "ptt_layer_norm", x2d,
                 gamma, beta, out, mean, var, R, H, plan.form, plan.n4,
                 int(vec), plan.rows, float(eps))
    (fused_layer_norm_bf16 if bf16 else fused_layer_norm).launches += 1
    return out, mean, var


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(x2d, gamma, beta, eps):
        return _ln_forward(x2d, gamma, beta, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, gamma, beta, eps = inputs
        _, mean, var = output
        ctx.save_for_backward(x2d, gamma, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        # the forward's own row statistics: no second pass over x
        x2d, gamma, mean, var = ctx.saved_tensors
        rstd = torch.rsqrt(var[:, None] + ctx.eps)
        xhat = (x2d.float() - mean[:, None]) * rstd
        dout = dout.float()
        dgamma = (dout * xhat).sum(0)
        dbeta = dout.sum(0)
        dxhat = dout * gamma.float()
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        return (dx.to(x2d.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def fused_layer_norm(x2d, gamma, beta, eps=1e-5):
    """(LayerNorm(x2d) * gamma + beta, mean, variance) over [R, H] rows;
    gamma and beta are [H], mean and variance [R] float32.
    Differentiable in x2d, gamma and beta through the normalized rows
    (dense backward)."""
    return _LayerNorm.apply(x2d, gamma, beta, float(eps))


fused_layer_norm.launches = 0


# the bf16 form's launches count apart from the float32 form's
fused_layer_norm_bf16 = build.LaunchCount("fused_layer_norm_bf16")
