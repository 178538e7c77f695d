"""sharded_linear_xent: the logits-free projected cross entropy over one
vocab shard, combined across the shards by per-row all-reduces.

Rank j of a vocab axis of n ranks holds w_local = w[:, col0 : col0 + V/n]
and runs three kernels on it, with labels in local coordinates
(y - col0: a label of another shard matches no local column):

    parts:  lse_j = logsumexp_v z[r, v],  gold_j = z[r, y_r - col0],
            sum_j = sum_v z[r, v],        over the local columns of
            z = x @ w_local (never stored);
    dx:     this shard's partial g @ w_local^T;
    dw:     x^T @ g for the local slab;

where g is ``fused_linear_xent``'s gradient recomputed from the GLOBAL
lse, the global row validity (0 <= y < vocab_total) and the smoothing
denominator vocab_total.  The forward combines the parts, in this order
on every rank:

    m = max_j lse_j,  lse = log(sum_j exp(lse_j - m)) + m,
    gold = sum_j gold_j,  sum = sum_j sum_j,
    loss = valid (1 - eps) (lse - gold) + eps (lse - sum / vocab_total),

so every rank holds the same full per-row loss, and the backward sums
dx over the shards, so every rank holds the same full dx.  (The
reference runs inside ``shard_map``, whose transpose splits the
cotangent and sums dx itself: it sums dy and leaves dx partial.  Here
each rank's dy is already whole, and the dx sum is explicit.)

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``sharded_linear_xent``:
``_lxent_parts`` (kernel body ``_lxent_parts_kernel``) and
``_lxent_bwd_sharded`` (``_lxent_dx_kernel_sharded``,
``_lxent_dw_kernel_sharded``).  The CUDA kernels are
``csrc/linear_xent.cu``'s, which share B4's tiles.
``linear_xent_parts_plain`` and ``linear_xent_grad_sharded_plain`` are
the plain PyTorch versions on the dense per-shard logits: CPU and meta
tensors take them, CUDA tensors launch the kernels.
"""

import torch

from ..parallel import collective
from . import build
from .linear_xent import _check, fwd_splits, lxent_plan

__all__ = ["sharded_linear_xent", "linear_xent_parts",
           "linear_xent_dx_sharded", "linear_xent_dw_sharded",
           "linear_xent_parts_plain", "linear_xent_grad_sharded_plain"]


def linear_xent_parts_plain(x2d, w_local, lbl_local):
    """(lse_j, gold_j, sum_j), each [R, 1] float32, from the dense
    logits of this shard."""
    lg = torch.matmul(x2d.float(), w_local.float())
    v = lg.shape[-1]
    lbl = lbl_local.reshape(-1).long()
    gold = torch.where(torch.arange(v, device=lg.device)[None, :]
                       == lbl[:, None], lg, torch.zeros_like(lg)).sum(
                           -1, keepdim=True)
    return (torch.logsumexp(lg, dim=-1, keepdim=True), gold,
            lg.sum(-1, keepdim=True))


def linear_xent_grad_sharded_plain(x2d, w_local, lbl_local, valid, lse, dy,
                                   eps, vocab_total):
    """(dx partial [R, H], dw [H, V/n]) from this shard's dense logits,
    the global lse and row validity, and the whole vocab's size."""
    lg = torch.matmul(x2d.float(), w_local.float())
    v = lg.shape[-1]
    p = torch.exp(lg - lse.reshape(-1, 1))
    lbl = lbl_local.reshape(-1).long()
    onehot = (torch.arange(v, device=lg.device)[None, :]
              == lbl[:, None]).float()
    g = valid.reshape(-1, 1).float() * (1.0 - eps) * (p - onehot)
    if eps:
        g = g + eps * (p - 1.0 / vocab_total)
    g = g * dy.reshape(-1, 1).float()
    return ((g @ w_local.float().t()).to(x2d.dtype),
            (x2d.float().t() @ g).to(w_local.dtype))


def linear_xent_parts(x2d, w_local, lbl_local):
    """Parts kernel: (lse_j, gold_j, sum_j), each [R, 1]."""
    if not build.use_kernel(x2d):
        return linear_xent_parts_plain(x2d, w_local, lbl_local)
    _check("linear_xent_parts", x2d, w_local, lbl_local)
    R, H = x2d.shape
    V = w_local.shape[1]
    splits = fwd_splits(R, V)
    out = [torch.empty((R, 1), dtype=torch.float32, device=x2d.device)
           for _ in range(3)]
    part = torch.empty((splits, 4, R), dtype=torch.float32, device=x2d.device)
    build.launch("ptt_linear_xent_parts", x2d, w_local, lbl_local, *out, part,
                 R, H, V, splits, *lxent_plan(R, H, V))
    linear_xent_parts.launches += 1
    return tuple(out)


def _grad_args(name, x2d, w_local, lbl_local, valid, lse, dy, vocab_total):
    _check(name, x2d, w_local, lbl_local, valid, lse, dy)
    if valid.numel() != x2d.shape[0] or vocab_total < w_local.shape[1]:
        raise ValueError("%s: valid %s for %d rows, vocab_total %d for a "
                         "slab of %d" % (name, tuple(valid.shape),
                                         x2d.shape[0], vocab_total,
                                         w_local.shape[1]))


def linear_xent_dx_sharded(x2d, w_local, lbl_local, valid, lse, dy, eps,
                           vocab_total):
    """dx kernel: this shard's partial g @ w_local^T."""
    if not build.use_kernel(x2d):
        return linear_xent_grad_sharded_plain(
            x2d, w_local, lbl_local, valid, lse, dy, eps, vocab_total)[0]
    _grad_args("linear_xent_dx_sharded", x2d, w_local, lbl_local, valid, lse,
               dy, vocab_total)
    R, H = x2d.shape
    dx = torch.empty_like(x2d)
    build.launch("ptt_linear_xent_dx_sharded", x2d, w_local, lbl_local, valid,
                 lse, dy, dx, R, H, w_local.shape[1], int(vocab_total),
                 *lxent_plan(R, H, w_local.shape[1]), float(eps))
    linear_xent_dx_sharded.launches += 1
    return dx


def linear_xent_dw_sharded(x2d, w_local, lbl_local, valid, lse, dy, eps,
                           vocab_total):
    """dw kernel: x^T @ g for the local slab."""
    if not build.use_kernel(x2d):
        return linear_xent_grad_sharded_plain(
            x2d, w_local, lbl_local, valid, lse, dy, eps, vocab_total)[1]
    _grad_args("linear_xent_dw_sharded", x2d, w_local, lbl_local, valid, lse,
               dy, vocab_total)
    R, H = x2d.shape
    dw = torch.empty_like(w_local)
    build.launch("ptt_linear_xent_dw_sharded", x2d, w_local, lbl_local, valid,
                 lse, dy, dw, R, H, w_local.shape[1], int(vocab_total),
                 *lxent_plan(R, H, w_local.shape[1]), float(eps))
    linear_xent_dw_sharded.launches += 1
    return dw


for _fn in (linear_xent_parts, linear_xent_dx_sharded, linear_xent_dw_sharded):
    _fn.launches = 0


class _ShardedLinearXent(torch.autograd.Function):
    @staticmethod
    def forward(x2d, w_local, labels, eps, group, col0, vocab_total):
        lbl_local = labels - col0
        lse_j, gold_j, sum_j = linear_xent_parts(x2d, w_local, lbl_local)
        m = collective.all_reduce(lse_j, group, "max")
        lse = torch.log(collective.all_reduce(torch.exp(lse_j - m), group)) + m
        gold = collective.all_reduce(gold_j, group)
        zsum = collective.all_reduce(sum_j, group)
        valid = ((labels >= 0) & (labels < vocab_total)).float()[:, None]
        loss = valid * (1.0 - eps) * (lse - gold)
        if eps:
            loss = loss + eps * (lse - zsum / vocab_total)
        return loss, lbl_local, valid, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, w_local, _, eps, group, _, vocab_total = inputs
        _, lbl_local, valid, lse = output
        ctx.save_for_backward(x2d, w_local, lbl_local, valid, lse)
        ctx.eps, ctx.group, ctx.vocab_total = eps, group, vocab_total
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, dloss, *_):
        x2d, w_local, lbl_local, valid, lse = ctx.saved_tensors
        dy = dloss.reshape(-1, 1).float().contiguous()
        dx, dw = _ShardedLinearXentGrad.apply(
            x2d, w_local, lbl_local, valid, lse, dy, ctx.eps, ctx.group,
            ctx.vocab_total)
        return dx, dw, None, None, None, None, None


class _ShardedLinearXentGrad(torch.autograd.Function):
    """(dx, dw) as a function of its own, as ``_LinearXentGrad``: under
    torch.func.vjp its forward is handed plain tensors, which a kernel
    and a collective can take.  dx is summed over the shards here; dw
    is the local slab's whole gradient.  Not differentiable again."""

    @staticmethod
    def forward(x2d, w_local, lbl_local, valid, lse, dy, eps, group,
                vocab_total):
        vld = valid.reshape(-1).contiguous()
        dx = linear_xent_dx_sharded(x2d, w_local, lbl_local, vld, lse, dy,
                                    eps, vocab_total)
        dw = linear_xent_dw_sharded(x2d, w_local, lbl_local, vld, lse, dy,
                                    eps, vocab_total)
        return collective.all_reduce(dx, group), dw

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ddx, ddw):
        raise NotImplementedError("sharded_linear_xent has no second "
                                  "derivative")


def sharded_linear_xent(x2d, w_local, labels, eps, group, col0, vocab_total):
    """Per-row loss [R, 1] float32 of the projected cross entropy over a
    vocab split across the ranks of `group` (a process group; None is a
    one-rank split): x2d [R, H] float32 (every rank's the same), w_local
    [H, V/n] this rank's slab of columns col0 ... col0 + V/n, labels [R]
    int64 in GLOBAL vocab coordinates, vocab_total = V.  Every rank
    issues the same four all-reduces in the forward and one in the
    backward, and gets the same loss and dx."""
    return _ShardedLinearXent.apply(x2d, w_local, labels, float(eps), group,
                                    int(col0), int(vocab_total))[0]
