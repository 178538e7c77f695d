"""fused_linear_xent: the logits-free projected cross entropy, forward
and backward as three kernels.

Per row r of x [R, H] with label y_r and smoothing eps, over the logits
z = x @ w (w [H, V]) that are never stored:

    loss_r = valid_r (1 - eps) (lse_r - z[r, y_r]) + eps (lse_r - mean_v z[r, v])

where valid_r says 0 <= y_r < V (a label outside the vocab gives the
smoothing term only, the one_hot convention).  The backward recomputes
each logits tile from the saved lse:

    g[r, v] = dy_r (valid_r (1 - eps) (p[r, v] - [v = y_r]) + eps (p[r, v] - 1/V)),
    p = exp(z - lse);   dx = g @ w^T,   dw = x^T @ g.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``fused_linear_xent``:
the forward ``_lxent_fwd`` (kernel body ``_lxent_fwd_kernel``) and the
backward ``_lxent_bwd``, whose dx and dw calls run ``_lxent_dx_kernel``
and ``_lxent_dw_kernel`` over ``_lxent_grad_tile``.  The CUDA kernels
are ``csrc/linear_xent.cu``.  ``linear_xent_plain`` and
``linear_xent_grad_plain`` are the plain PyTorch versions (the
reference's ``_linear_xent_dense``, which materializes the logits): CPU
and meta tensors take them, CUDA tensors launch the kernels.

``fused_linear_xent`` is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``): its forward saves the per-row lse, its backward
launches dx and dw, so the op's grad lowering (``torch.func.vjp`` of
the forward rule) runs the kernels.
"""

from typing import NamedTuple

import torch

from . import build

__all__ = ["fused_linear_xent", "linear_xent_plain", "linear_xent_grad_plain",
           "linear_xent_fwd", "linear_xent_dx", "linear_xent_dw", "lxent_plan",
           "LxentPlan"]


def _valid(labels, v):
    return (labels >= 0) & (labels < v)


def linear_xent_plain(x2d, w, labels, eps=0.0):
    """(loss [R, 1], lse [R, 1]) in float32 from the dense logits."""
    lg = torch.matmul(x2d.float(), w.float())
    v = lg.shape[-1]
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    lbl = labels.reshape(-1).long()
    gold = torch.where(torch.arange(v, device=lg.device)[None, :]
                       == lbl[:, None], lg, torch.zeros_like(lg)).sum(
                           -1, keepdim=True)
    valid = _valid(lbl, v)[:, None]
    loss = torch.where(valid, (1.0 - eps) * (lse - gold), torch.zeros_like(lse))
    if eps:
        loss = loss + eps * (lse - lg.mean(-1, keepdim=True))
    return loss, lse


def linear_xent_grad_plain(x2d, w, labels, lse, dy, eps=0.0):
    """(dx [R, H], dw [H, V]) from the dense logits and the saved lse."""
    lg = torch.matmul(x2d.float(), w.float())
    v = lg.shape[-1]
    p = torch.exp(lg - lse.reshape(-1, 1))
    lbl = labels.reshape(-1).long()
    onehot = (torch.arange(v, device=lg.device)[None, :]
              == lbl[:, None]).float()
    valid = _valid(lbl, v).float()[:, None]
    g = valid * (1.0 - eps) * (p - onehot)
    if eps:
        g = g + eps * (p - 1.0 / v)
    g = g * dy.reshape(-1, 1).float()
    return ((g @ w.float().t()).to(x2d.dtype),
            (x2d.float().t() @ g).to(w.dtype))


def _check(name, x2d, w, labels, *rows):
    build.check_inputs(name, x2d, w, *rows)
    R, H = x2d.shape
    if w.dim() != 2 or w.shape[0] != H or labels.numel() != R:
        raise ValueError("%s: shapes x %s, w %s, labels %s" % (
            name, tuple(x2d.shape), tuple(w.shape), tuple(labels.shape)))
    if labels.dtype != torch.int64 or not labels.is_contiguous() or (
            labels.device != x2d.device):
        raise TypeError("%s: labels must be contiguous int64 on %s" % (
            name, x2d.device))
    if max(R * H, H * w.shape[1]) >= 2 ** 31:
        raise ValueError("%s: operands exceed the kernel's 32-bit indexing"
                         % name)


def fwd_splits(R, V):
    """The forward kernel's vocab split count: enough (64-row tile, split)
    blocks for about two per SM, from R and V alone, so a given shape
    always sums in the same order."""
    row_tiles, vocab_tiles = -(-R // 64), -(-V // 64)
    return max(1, min(vocab_tiles, -(-256 // row_tiles)))


SMEM_MAX = 232448  # dynamic shared memory a block can have on the H100
SUB_SLICE = 768    # the widest pass a dx / dw block's registers hold


class LxentPlan(NamedTuple):
    """How ``csrc/linear_xent.cu`` cuts a shape into its 64 x 64 logits
    tiles; the C entry points take these four ints in this order.  hs: the
    H slice; n: slices (dx / dw cluster size); stages: the cp.async ring's
    depth; smem: dynamic shared-memory bytes a block."""
    hs: int
    n: int
    stages: int
    smem: int


def lxent_plan(R, H, V):
    """The kernels' plan for x [R, H] @ w [H, V], from H alone, so a
    shape always sums in one order: H in slices of 256 while that takes
    at most 8 (the portable cluster size), else 8 slices of
    round_up(ceil(H / 8), 32).  Each logit is the sum, in slice order, of
    per-slice 3xTF32 partials over 64-deep steps.  A 256 slice keeps dx's
    x rows ([64, 256]) or dw's w columns ([256, 64]) resident, and the
    ring holds the tile's 4 chunks [64, 64] of the other operand (read
    again by the product) and 2 ahead; a wider slice streams 3 or 4
    stages of x and w chunks or of 16 x min(hs, 768), and a slice wider
    than 768 (H > 6144) is done in passes of 768.  The forward's ring of
    (x, w) chunk pairs takes as many as smem holds, at most 4."""
    if min(R, H, V) < 0:
        raise ValueError("lxent_plan: shape R %d, H %d, V %d" % (R, H, V))
    n = max(1, -(-H // 256))
    hs = 256
    if n > 8:
        n = 8
        hs = -(-H // (8 * 32)) * 32  # round_up(ceil(H / 8), 32)
    tile = 64 * 64
    fixed = 4 * 4 * tile  # two k-half partials, a share of z, the g tile
    if hs == 256:
        stages = hs // 64 + 2
        return LxentPlan(hs, n, stages, 4 * (64 * hs + stages * tile) + fixed)
    stage = 4 * max(2 * 64 * 64, 16 * min(hs, SUB_SLICE))
    stages = min(4, (SMEM_MAX - fixed) // stage)
    return LxentPlan(hs, n, stages, stages * stage + fixed)


def linear_xent_fwd(x2d, w, labels, eps=0.0):
    """Forward kernel: (loss [R, 1], lse [R, 1])."""
    if not build.use_kernel(x2d):
        return linear_xent_plain(x2d, w, labels, eps)
    _check("linear_xent_fwd", x2d, w, labels)
    R, H = x2d.shape
    V = w.shape[1]
    splits = fwd_splits(R, V)
    loss = torch.empty((R, 1), dtype=torch.float32, device=x2d.device)
    lse = torch.empty((R, 1), dtype=torch.float32, device=x2d.device)
    part = torch.empty((splits, 4, R), dtype=torch.float32, device=x2d.device)
    build.launch("ptt_linear_xent_fwd", x2d, w, labels, loss, lse, part, R, H,
                 V, splits, *lxent_plan(R, H, V), float(eps))
    linear_xent_fwd.launches += 1
    return loss, lse


def linear_xent_dx(x2d, w, labels, lse, dy, eps=0.0):
    """dx kernel: g @ w^T, g recomputed per vocab tile from lse."""
    if not build.use_kernel(x2d):
        return linear_xent_grad_plain(x2d, w, labels, lse, dy, eps)[0]
    _check("linear_xent_dx", x2d, w, labels, lse, dy)
    R, H = x2d.shape
    dx = torch.empty_like(x2d)
    build.launch("ptt_linear_xent_dx", x2d, w, labels, lse, dy, dx, R, H,
                 w.shape[1], *lxent_plan(R, H, w.shape[1]), float(eps))
    linear_xent_dx.launches += 1
    return dx


def linear_xent_dw(x2d, w, labels, lse, dy, eps=0.0):
    """dw kernel: x^T @ g per vocab tile, summed over row tiles in order."""
    if not build.use_kernel(x2d):
        return linear_xent_grad_plain(x2d, w, labels, lse, dy, eps)[1]
    _check("linear_xent_dw", x2d, w, labels, lse, dy)
    R, H = x2d.shape
    dw = torch.empty_like(w)
    build.launch("ptt_linear_xent_dw", x2d, w, labels, lse, dy, dw, R, H,
                 w.shape[1], *lxent_plan(R, H, w.shape[1]), float(eps))
    linear_xent_dw.launches += 1
    return dw


for _fn in (linear_xent_fwd, linear_xent_dx, linear_xent_dw):
    _fn.launches = 0


class _LinearXent(torch.autograd.Function):
    @staticmethod
    def forward(x2d, w, labels, eps):
        return linear_xent_fwd(x2d, w, labels, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, w, labels, eps = inputs
        ctx.save_for_backward(x2d, w, labels, output[1])
        ctx.eps = eps
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, dloss, _dlse):
        x2d, w, labels, lse = ctx.saved_tensors
        dy = dloss.reshape(-1, 1).float().contiguous()
        dx, dw = _LinearXentGrad.apply(x2d, w, labels, lse, dy, ctx.eps)
        return dx, dw, None, None


class _LinearXentGrad(torch.autograd.Function):
    """(dx, dw) as a function of its own.  Under torch.func.vjp the
    backward above sees wrapped tensors, which have no storage for a
    kernel to read; an autograd.Function's forward is handed the plain
    tensors underneath.  Not differentiable again."""

    @staticmethod
    def forward(x2d, w, labels, lse, dy, eps):
        if not build.use_kernel(x2d):
            return linear_xent_grad_plain(x2d, w, labels, lse, dy, eps)
        return (linear_xent_dx(x2d, w, labels, lse, dy, eps),
                linear_xent_dw(x2d, w, labels, lse, dy, eps))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ddx, ddw):
        raise NotImplementedError("fused_linear_xent has no second derivative")


def fused_linear_xent(x2d, w, labels, eps=0.0):
    """Per-row loss [R, 1] float32 of the projected cross entropy; x2d
    [R, H] and w [H, V] float32, labels [R] int64.  Differentiable in x2d
    and w (the backward runs the dx and dw kernels on CUDA tensors)."""
    return _LinearXent.apply(x2d, w, labels, float(eps))[0]
