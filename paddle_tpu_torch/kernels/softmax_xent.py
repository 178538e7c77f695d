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

``sxent_plan`` picks the kernels' form from C alone, so a row's sums run
in one order whatever R is: the warp form up to ``WARP_MAX_C`` columns;
then the staged form, the row cut into 1, 2, 4 or 8 parts of at most
``PART_FLOATS`` floats (as many as fit shared memory at 8), each staged
in one block's shared memory, the blocks of a row one cluster, so the
backward reads each row once; past that the two-read row form.  No path
runs the staged or the two-read form today: BERT's MLM head, the one
path with rows past 1024 columns, is folded into ``linear_xent`` by
``linear_xent_fuse_pass``.  The staged form's constants were tuned at
[4096, 30522] alone; a step that runs such a head unfused (BERT
without that pass) would have to exist before they are tuned again.
"""

import collections

import torch

from . import build

__all__ = ["fused_softmax_xent", "softmax_xent_plain",
           "softmax_xent_grad_plain", "softmax_xent_fwd", "softmax_xent_bwd",
           "sxent_plan"]

WARP, STAGED, TWO_READ = 0, 1, 2  # the plan's forms
WARP_MAX_C = 1024  # 32 values a lane
CTAS = (1, 2, 4, 8)  # blocks a row (a cluster) in the staged form
# the most floats a staged block takes before the row spreads over more
# blocks (8 blocks take up to what shared memory holds)
PART_FLOATS = 8192
# a staged block's threads: one per 64 floats of its part, at least 64
# (at [4096, 30522] 4 blocks of 128 threads ran fastest on an H100,
# scripts/row_kernels_check.py)
THREAD_FLOATS, MIN_THREADS = 64, 64
STAGE_BYTES = 232448 - 1024  # a block's dynamic shared memory at most (C side)
STAGED_MAX_C = CTAS[-1] * (STAGE_BYTES // 4 - 4)

SxentPlan = collections.namedtuple("SxentPlan", "form ctas threads smem")


def sxent_plan(R, C):
    """The kernels' form for [R, C] logits: (form, ctas, threads, smem).
    WARP for C <= WARP_MAX_C (the other three 0).  STAGED up to
    STAGED_MAX_C: the fewest blocks a row of CTAS whose parts (ceil(C /
    ctas) rounded up to a multiple of 4) hold at most PART_FLOATS (8
    blocks past that), one thread per THREAD_FLOATS of a part (MIN_THREADS
    to 1024, whole warps), and the part's stage in bytes with 3 floats of
    slack (at most STAGE_BYTES).  TWO_READ beyond (all 0).  Raises where
    no form takes the shape.  The staged form serves no path today (see
    the module's docstring)."""
    if not 1 <= C < 2 ** 31 or not 0 <= R < 2 ** 31:
        raise ValueError("fused_softmax_xent: [%d, %d] is past the kernels' "
                         "1 to 2**31 - 1 columns or 32-bit row count"
                         % (R, C))
    if C <= WARP_MAX_C:
        return SxentPlan(WARP, 0, 0, 0)
    if C > STAGED_MAX_C:
        return SxentPlan(TWO_READ, 0, 0, 0)
    ctas = next((n for n in CTAS if -(-C // n) <= PART_FLOATS), CTAS[-1])
    part = -(-C // ctas) + 3 & ~3
    if ctas * R >= 2 ** 31:
        raise ValueError("fused_softmax_xent: [%d, %d] needs %d blocks, past "
                         "the grid's 2**31 - 1" % (R, C, ctas * R))
    threads = 32 * min(32, max(MIN_THREADS // 32,
                                -(-part // (32 * THREAD_FLOATS))))
    return SxentPlan(STAGED, ctas, threads, 4 * (part + 4))


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
    build.launch("ptt_softmax_xent_fwd", logits, labels, loss,
                 *sxent_plan(R, C), R, C)
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
    build.launch("ptt_softmax_xent_bwd", logits, labels, dy, dx,
                 *sxent_plan(R, C), R, C)
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
