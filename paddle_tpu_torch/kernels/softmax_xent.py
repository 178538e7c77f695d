"""fused_softmax_xent: per-row softmax cross entropy with hard labels,
forward and backward as two kernels.

Per row r of logits x [R, C] with integer label y_r:

    loss_r = lse_r - gold_r,   gold_r = x[r, y_r] if 0 <= y_r < C else 0
    dx[r, c] = (softmax(x)[r, c] - [c = y_r]) dy_r

A label outside [0, C) matches no column (the reference kernel's iota
compare): its loss is the row's lse and its one-hot row is all zero.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``fused_softmax_xent``:
the forward ``_sxent_fwd_call`` (kernel body ``_sxent_kernel``) and the
backward ``_sxent_bwd_call`` (``_sxent_bwd_kernel``), which recomputes
the row max and sum from the logits.  The CUDA kernels are
``csrc/softmax_xent.cu``.  ``softmax_xent_plain`` and
``softmax_xent_grad_plain`` are the plain PyTorch versions of the
kernels' math: CPU and meta tensors take them, CUDA tensors launch the
kernels.

``fused_softmax_xent`` is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``), so the ``softmax_with_cross_entropy`` grad op
(``torch.func.vjp`` of the forward rule) runs the backward kernel.
"""

import torch

from . import build

__all__ = ["fused_softmax_xent", "softmax_xent_plain",
           "softmax_xent_grad_plain", "softmax_xent_fwd", "softmax_xent_bwd"]


def _onehot(labels, c, device):
    return torch.arange(c, device=device)[None, :] == labels.reshape(-1, 1)


def softmax_xent_plain(logits, labels):
    """loss [R, 1] float32."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1, keepdim=True)
    gold = torch.where(_onehot(labels.long(), x.shape[-1], x.device), x,
                       torch.zeros_like(x)).sum(-1, keepdim=True)
    return lse - gold


def softmax_xent_grad_plain(logits, labels, dy):
    """dx [R, C] in the logits' dtype."""
    x = logits.float()
    onehot = _onehot(labels.long(), x.shape[-1], x.device).float()
    dx = (torch.softmax(x, dim=-1) - onehot) * dy.reshape(-1, 1).float()
    return dx.to(logits.dtype)


def _validate(logits, labels):
    """The reference's loud shape contract (``_sxent_validate``): 2-D
    logits, one integer label per row."""
    if logits.dim() != 2:
        raise ValueError(
            "fused_softmax_xent: logits must be 2-D [rows, classes], got "
            "shape %s — reshape leading dims into rows first"
            % (tuple(logits.shape),))
    rows = int(logits.shape[0])
    if labels.dim() > 2 or labels.numel() != rows or (
            labels.dim() == 2 and labels.shape[1] != 1):
        raise ValueError(
            "fused_softmax_xent: labels must be [rows]=%d (or [rows, 1]) "
            "ints, got shape %s" % (rows, tuple(labels.shape)))
    if labels.is_floating_point() or labels.is_complex() or (
            labels.dtype == torch.bool):
        raise ValueError("fused_softmax_xent: labels must be integers, got %s"
                         % labels.dtype)


def _check(name, logits, labels, *rows):
    build.check_inputs(name, logits, *rows)
    R, C = logits.shape
    if C == 0 or labels.numel() != R or any(t.numel() != R for t in rows):
        raise ValueError("%s: shapes logits %s, labels %s" % (
            name, tuple(logits.shape), tuple(labels.shape)))
    if labels.dtype != torch.int64 or not labels.is_contiguous() or (
            labels.device != logits.device):
        raise TypeError("%s: labels must be contiguous int64 on %s" % (
            name, logits.device))
    if R >= 2 ** 31 or C >= 2 ** 31:
        raise ValueError("%s: %d x %d exceeds the kernel's 32-bit row and "
                         "column indices" % (name, R, C))


def softmax_xent_fwd(logits, labels):
    """Forward kernel: loss [R, 1] float32 from logits [R, C] and int64
    labels [R]."""
    if not build.use_kernel(logits):
        return softmax_xent_plain(logits, labels)
    _check("softmax_xent_fwd", logits, labels)
    R, C = logits.shape
    loss = torch.empty((R, 1), dtype=torch.float32, device=logits.device)
    build.launch("ptt_softmax_xent_fwd", logits, labels, loss, R, C)
    softmax_xent_fwd.launches += 1
    return loss


def softmax_xent_bwd(logits, labels, dy):
    """Backward kernel: dx [R, C] from logits, labels and dy [R, 1]; the
    row max and sum are recomputed from the logits."""
    if not build.use_kernel(logits):
        return softmax_xent_grad_plain(logits, labels, dy)
    _check("softmax_xent_bwd", logits, labels, dy)
    R, C = logits.shape
    dx = torch.empty_like(logits)
    build.launch("ptt_softmax_xent_bwd", logits, labels, dy, dx, R, C)
    softmax_xent_bwd.launches += 1
    return dx


for _fn in (softmax_xent_fwd, softmax_xent_bwd):
    _fn.launches = 0


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(logits, labels):
        return softmax_xent_fwd(logits, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dloss):
        logits, labels = ctx.saved_tensors
        dy = dloss.reshape(-1, 1).float().contiguous()
        return _SoftmaxXentGrad.apply(logits, labels, dy), None


class _SoftmaxXentGrad(torch.autograd.Function):
    """dx as a function of its own.  Under torch.func.vjp the backward
    above sees wrapped tensors, which have no storage for a kernel to
    read; an autograd.Function's forward is handed the plain tensors
    underneath.  Not differentiable again."""

    @staticmethod
    def forward(logits, labels, dy):
        return softmax_xent_bwd(logits, labels, dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ddx):
        raise NotImplementedError("fused_softmax_xent has no second "
                                  "derivative")


def fused_softmax_xent(logits, labels):
    """Per-row loss [R, 1] float32 of the softmax cross entropy; logits
    [R, C], labels [R] or [R, 1] integers (the CUDA kernels take float32
    logits and contiguous int64 labels).  Differentiable in the logits
    (the backward runs the backward kernel on CUDA tensors)."""
    _validate(logits, labels)
    return _SoftmaxXent.apply(logits, labels.reshape(-1))
