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

bf16: bfloat16 x and w_local (the AMP pass's mirror of the float32
master slab) launch the bf16 forms (``csrc/linear_xent_bf16.cu``,
B4's bf16 tiles): lse, gold and sum stay float32 [R, 1], and so do the
row validity, lse and dy the backward takes; g is rounded to bfloat16
before each product, as the reference's kernels do (``g.astype(
x_ref.dtype)``), and dx and dw come back in bfloat16.  The dx partials
are summed over the shards in bfloat16, as the reference's shard_map
transpose sums its bf16 cotangents.  Each bf16 form counts its launches
apart (``linear_xent_parts_bf16``, ``linear_xent_dx_sharded_bf16``,
``linear_xent_dw_sharded_bf16``).
"""

import torch

from ..parallel import collective
from . import build
from .linear_xent import _check, fwd_splits, lxent_plan

__all__ = ["sharded_linear_xent", "linear_xent_parts",
           "linear_xent_dx_sharded", "linear_xent_dw_sharded",
           "linear_xent_parts_bf16", "linear_xent_dx_sharded_bf16",
           "linear_xent_dw_sharded_bf16", "linear_xent_parts_plain",
           "linear_xent_grad_sharded_plain"]


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
    # rounded to the operands' dtype before the products, as the
    # reference's dx / dw kernels do (a no-op in float32)
    g = (g * dy.reshape(-1, 1).float()).to(x2d.dtype).float()
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
    if x2d.dtype == torch.bfloat16:
        build.launch("ptt_linear_xent_parts_bf16", x2d, w_local, lbl_local,
                     *out, part, R, H, V, splits)
        linear_xent_parts_bf16.launches += 1
    else:
        build.launch("ptt_linear_xent_parts", x2d, w_local, lbl_local, *out,
                     part, R, H, V, splits, *lxent_plan(R, H, V))
        linear_xent_parts.launches += 1
    return tuple(out)


def _grad_kernel(fn, x2d, w_local, lbl_local, valid, lse, dy, eps,
                 vocab_total):
    """Launch wrapper `fn`'s kernel (dx or dw, by name) in the operands'
    form: the float32 form with lxent_plan's ints, or the bf16 form,
    counted under its own name; returns its output, x's shape for dx and
    w_local's for dw."""
    name = fn.__name__
    _check(name, x2d, w_local, lbl_local, valid, lse, dy)
    R, H = x2d.shape
    V = w_local.shape[1]
    if valid.numel() != R or vocab_total < V:
        raise build.KernelInputError(
            "%s: valid %s for %d rows, vocab_total %d for a slab of %d" % (
                name, tuple(valid.shape), R, vocab_total, V))
    out = torch.empty_like(x2d if name == "linear_xent_dx_sharded"
                           else w_local)
    args = (x2d, w_local, lbl_local, valid, lse, dy, out, R, H, V,
            int(vocab_total))
    if x2d.dtype == torch.bfloat16:
        build.launch("ptt_%s_bf16" % name, *args, float(eps))
        _BF16_COUNTS[name].launches += 1
    else:
        build.launch("ptt_" + name, *args, *lxent_plan(R, H, V), float(eps))
        fn.launches += 1
    return out


def linear_xent_dx_sharded(x2d, w_local, lbl_local, valid, lse, dy, eps,
                           vocab_total):
    """dx kernel: this shard's partial g @ w_local^T."""
    if not build.use_kernel(x2d):
        return linear_xent_grad_sharded_plain(
            x2d, w_local, lbl_local, valid, lse, dy, eps, vocab_total)[0]
    return _grad_kernel(linear_xent_dx_sharded, x2d, w_local, lbl_local,
                        valid, lse, dy, eps, vocab_total)


def linear_xent_dw_sharded(x2d, w_local, lbl_local, valid, lse, dy, eps,
                           vocab_total):
    """dw kernel: x^T @ g for the local slab."""
    if not build.use_kernel(x2d):
        return linear_xent_grad_sharded_plain(
            x2d, w_local, lbl_local, valid, lse, dy, eps, vocab_total)[1]
    return _grad_kernel(linear_xent_dw_sharded, x2d, w_local, lbl_local,
                        valid, lse, dy, eps, vocab_total)


for _fn in (linear_xent_parts, linear_xent_dx_sharded, linear_xent_dw_sharded):
    _fn.launches = 0
# the bf16 forms' launches count apart from the float32 forms'
linear_xent_parts_bf16 = build.LaunchCount("linear_xent_parts_bf16")
linear_xent_dx_sharded_bf16 = build.LaunchCount("linear_xent_dx_sharded_bf16")
linear_xent_dw_sharded_bf16 = build.LaunchCount("linear_xent_dw_sharded_bf16")
_BF16_COUNTS = {"linear_xent_dx_sharded": linear_xent_dx_sharded_bf16,
                "linear_xent_dw_sharded": linear_xent_dw_sharded_bf16}


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
    one-rank split): x2d [R, H] (every rank's the same) and w_local [H,
    V/n], this rank's slab of columns col0 ... col0 + V/n, both float32
    or both bfloat16 (then dx and dw are bfloat16), labels [R]
    int64 in GLOBAL vocab coordinates, vocab_total = V.  Every rank
    issues the same four all-reduces in the forward and one in the
    backward, and gets the same loss and dx."""
    return _ShardedLinearXent.apply(x2d, w_local, labels, float(eps), group,
                                    int(col0), int(vocab_total))[0]
