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

``add_ln_plan`` picks the kernel's form from the shape: the row in
registers over ``warps`` warps (one warp up to ``WARP_SLOTS`` float4
slots a lane, then 2, 4 or 8), ``n4`` slots a lane, as many rows a block
as keep every SM busy.  Warps and slots depend on H alone, so a row's
sums run in one order whatever R is.
"""

import collections

import torch

from . import build

__all__ = ["fused_add_layer_norm", "add_layer_norm_plain", "add_ln_plan"]

N4_SLOTS = (1, 2, 3, 4, 6, 8, 12, 16)  # the kernel's instantiations
# the most float4 slots a lane before a row spreads over more warps: on an
# H100, H 768 (6 slots) ran fastest on one warp and H 2048 on four warps
# of 4 slots at every path row count (scripts/row_kernels_check.py)
WARP_SLOTS = 6
MAX_WARPS = 8  # warps a block: rows x warps a row
MAX_H = 128 * N4_SLOTS[-1] * MAX_WARPS  # 16384: 8 warps of 16 slots
# the H100 SXM's SMs, as ln_plan takes them: on another card only the
# rows a block shift, never a row's result
SMS = 132

AddLnPlan = collections.namedtuple("AddLnPlan", "n4 vec warps rows")


def add_ln_plan(R, H):
    """The kernel's form for [R, H] rows: (n4, vec, warps, rows).  warps
    a row: the fewest of 1, 2, 4, 8 that hold the row's ceil(H / 128)
    float4 slots at WARP_SLOTS a lane (8 warps take up to 16); n4: the
    least instantiated count with 128 n4 warps >= H; vec: H % 4 == 0 (the
    wrapper also needs 16-byte rows); rows a block: the most (rows x
    warps <= 8) that still give every SM a block.  Raises where the
    kernel cannot take the shape."""
    if not 1 <= H <= MAX_H or not 0 <= R < 2 ** 31:
        raise ValueError("fused_add_layer_norm: [%d, %d] is past the kernel's "
                         "rows of 1 to %d floats or 32-bit row count"
                         % (R, H, MAX_H))
    need = -(-H // 128)
    warps = 1
    while warps < MAX_WARPS and need > WARP_SLOTS * warps:
        warps *= 2
    n4 = next(n for n in N4_SLOTS if n * warps >= need)
    rows = max(1, min(MAX_WARPS // warps, R // SMS))
    return AddLnPlan(n4, int(H % 4 == 0), warps, rows)


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
    plan = add_ln_plan(R, H)
    s = torch.empty_like(x2d)
    out = torch.empty_like(x2d)
    mean = torch.empty(R, dtype=torch.float32, device=x2d.device)
    var = torch.empty(R, dtype=torch.float32, device=x2d.device)
    # float4 access needs 16-byte aligned rows (a view may start anywhere)
    vec = plan.vec and all(t.data_ptr() % 16 == 0
                           for t in (x2d, y2d, gamma, beta, s, out))
    build.launch("ptt_add_layer_norm", x2d, y2d, gamma, beta, s, out, mean,
                 var, R, H, plan.n4, int(vec), plan.warps, plan.rows,
                 float(eps))
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
