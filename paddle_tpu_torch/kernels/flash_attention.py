"""Flash attention: the training form (forward, dq, dk/dv) and the
per-row offset-causal serving form (forward).

``flash_attention`` replaces ``paddle_tpu/ops/pallas_kernels.py``
``flash_attention``: the forward ``_flash_fwd`` (kernel body
``_flash_fwd_kernel``) and the backward ``_flash_bwd``, whose dq and
dk/dv calls run ``_flash_dq_kernel`` and ``_flash_dkv_kernel``.  The
CUDA kernels are ``csrc/flash_attention.cu``.  Over q [BH, Tq, d] and
k, v [BH, Tk, d] with an optional additive key bias [BH, Tk] and causal
masking (Tq == Tk):

    s = q k^T * scale + kbias,   lse = logsumexp(s),   o = exp(s - lse) v

and the backward rebuilds p = exp(s - lse) from the saved lse:

    delta = rowsum(o * do),   ds = p * (do v^T - delta),
    dq = scale * ds k,   dk = scale * ds^T q,   dv = p^T do,
    dkbias = column sums of ds.

``flash_attention_plain`` (o, lse) and ``flash_attention_grad_plain``
(dq, dk, dv, dkbias) are the plain PyTorch versions (the reference's
``_dense_attention``, with its lse): CPU and meta tensors take them,
CUDA tensors launch the kernels.  ``flash_attention`` is a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``): its
forward saves o and lse, its backward launches dq and dk/dv.  The
sliding-window and segment-id forms are still to be ported (ROADMAP
B3-window/segments): they raise on CUDA tensors.

``flash_attention_qvec`` replaces ``flash_attention_qvec`` (``_flash_fwd``
with ``qvec``); the CUDA kernel is ``csrc/flash_attention_qvec.cu``.
``flash_attention_qvec_plain`` is its plain version (the dense
vector-QStart branch of the reference's ``fused_attention`` lowering).
Its backward (dq, dk/dv) is still to be ported, see ROADMAP.
"""

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_grad_plain", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_qvec", "flash_attention_qvec_plain", "NEG_INF"]

NEG_INF = -1e30
# the qvec kernel's fixed key split: keys in slices of this many (a
# multiple of its 32-key tile), merged by log-sum-exp in slice order
KV_CHUNK = 128


def _scores(q, k, kbias, causal, scale):
    """[BH, Tq, Tk] float32 scores with the key bias and the causal mask
    (NEG_INF) applied."""
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * float(scale)
    if kbias is not None:
        s = s + kbias[:, None, :].float()
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(keep[None], s, torch.full((), NEG_INF,
                                                  device=q.device))
    return s


def flash_attention_plain(q, k, v, kbias=None, causal=False, scale=None):
    """(o [BH, Tq, d], lse [BH, Tq] float32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, kbias, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v), lse


def flash_attention_grad_plain(q, k, v, kbias, lse, do, delta, causal=False,
                               scale=None):
    """(dq, dk, dv, dkbias [BH, Tk] float32) from the saved lse and
    delta = rowsum(o * do); rows whose lse is the NEG_INF sentinel take
    no gradient (the reference's guard)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, kbias, causal, scale)
    lse = lse.float()[..., None]
    p = torch.where(lse <= NEG_INF / 2, torch.zeros((), device=q.device),
                    torch.exp(s - lse))
    dof = do.float()
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta.float()[..., None])
    dq = float(scale) * torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = float(scale) * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(1))


def _check(name, q, k, v, kbias, causal, *rows):
    build.check_inputs(name, q, k, v, *rows,
                       *(() if kbias is None else (kbias,)))
    bh, tq, d = q.shape
    tk = k.shape[1]
    if (tuple(k.shape) != (bh, tk, d) or tuple(v.shape) != (bh, tk, d)
            or (kbias is not None and tuple(kbias.shape) != (bh, tk))):
        raise ValueError("%s: shapes q %s k %s v %s kbias %s" % (
            name, tuple(q.shape), tuple(k.shape), tuple(v.shape),
            None if kbias is None else tuple(kbias.shape)))
    if causal and tq != tk:
        raise ValueError("%s: causal requires Tq == Tk, got %d vs %d"
                         % (name, tq, tk))
    if d not in (64, 128):
        raise ValueError("%s: the CUDA kernels are built for head dims 64 "
                         "and 128, got %d" % (name, d))
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("%s: operands exceed the kernels' 32-bit row "
                         "indexing" % name)
    return bh, tq, tk, d


def flash_attention_fwd(q, k, v, kbias=None, causal=False, scale=None):
    """Forward kernel: (o, lse)."""
    if not build.use_kernel(q):
        return flash_attention_plain(q, k, v, kbias, causal, scale)
    bh, tq, tk, d = _check("flash_attention_fwd", q, k, v, kbias, causal)
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    build.launch("ptt_flash_attention_fwd", q, k, v, kbias, o, lse, bh, tq,
                 tk, d, int(bool(causal)), float(scale))
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_dq(q, k, v, kbias, lse, do, delta, causal=False,
                       scale=None):
    """dq kernel: one block per query tile walks the key tiles in order."""
    if not build.use_kernel(q):
        return flash_attention_grad_plain(q, k, v, kbias, lse, do, delta,
                                          causal, scale)[0]
    bh, tq, tk, d = _check("flash_attention_dq", q, k, v, kbias, causal,
                           lse, do, delta)
    if scale is None:
        scale = d ** -0.5
    dq = torch.empty_like(q)
    build.launch("ptt_flash_attention_dq", q, k, v, kbias, lse, do, delta, dq,
                 bh, tq, tk, d, int(bool(causal)), float(scale))
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, kbias, lse, do, delta, causal=False,
                        scale=None):
    """dk/dv kernel: (dk, dv, dkbias or None); one block per key tile
    walks the query tiles in order."""
    if not build.use_kernel(q):
        _, dk, dv, dkb = flash_attention_grad_plain(q, k, v, kbias, lse, do,
                                                    delta, causal, scale)
        return dk, dv, (dkb if kbias is not None else None)
    bh, tq, tk, d = _check("flash_attention_dkv", q, k, v, kbias, causal,
                           lse, do, delta)
    if scale is None:
        scale = d ** -0.5
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dkb = (torch.empty((bh, tk), dtype=torch.float32, device=q.device)
           if kbias is not None else None)
    build.launch("ptt_flash_attention_dkv", q, k, v, kbias, lse, do, delta,
                 dk, dv, dkb, bh, tq, tk, d, int(bool(causal)), float(scale))
    flash_attention_dkv.launches += 1
    return dk, dv, dkb


for _fn in (flash_attention_fwd, flash_attention_dq, flash_attention_dkv):
    _fn.launches = 0


def _flash_grad(q, k, v, kbias, lse, do, delta, causal, scale):
    """(dq, dk, dv[, dkbias]): the dq and dk/dv kernels on CUDA tensors,
    one plain pass for all four otherwise."""
    if build.use_kernel(q):
        dq = flash_attention_dq(q, k, v, kbias, lse, do, delta, causal, scale)
        dk, dv, dkb = flash_attention_dkv(q, k, v, kbias, lse, do, delta,
                                          causal, scale)
    else:
        dq, dk, dv, dkb = flash_attention_grad_plain(q, k, v, kbias, lse, do,
                                                     delta, causal, scale)
    return (dq, dk, dv) if kbias is None else (dq, dk, dv, dkb)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, kbias, causal, scale):
        return flash_attention_fwd(q, k, v, kbias, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, kbias, causal, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, kbias, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kbias, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1)
        grads = _FlashAttentionGrad.apply(
            q, k, v, kbias, lse, do.contiguous(), delta.contiguous(),
            ctx.causal, ctx.scale)
        dkb = grads[3] if kbias is not None else None
        return grads[0], grads[1], grads[2], dkb, None, None


class _FlashAttentionGrad(torch.autograd.Function):
    """(dq, dk, dv[, dkbias]) as a function of its own.  Under
    torch.func.vjp the backward above sees wrapped tensors, which have
    no storage for a kernel to read; an autograd.Function's forward is
    handed the plain tensors underneath.  Not differentiable again."""

    @staticmethod
    def forward(q, k, v, kbias, lse, do, delta, causal, scale):
        return _flash_grad(q, k, v, kbias, lse, do, delta, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative")


def flash_attention(q, k, v, kbias=None, causal=False, scale=None):
    """Attention over q [BH, Tq, d], k/v [BH, Tk, d] float32, with an
    optional additive key bias [BH, Tk] and causal masking (Tq == Tk).
    Differentiable in q, k, v and kbias (the backward runs the dq and
    dk/dv kernels on CUDA tensors)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kbias, bool(causal), float(scale))[0]


def flash_attention_qvec_plain(q, k, v, qstart, scale=None):
    """q [BH, Tq, d], k/v [BH, Tk, d], qstart [BH] int: query i of row b
    attends keys 0 .. qstart[b] + i."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * float(scale)
    q_pos = (qstart.reshape(bh, 1).long()
             + torch.arange(tq, device=q.device)[None, :])
    keep = q_pos[:, :, None] >= torch.arange(tk, device=q.device)[None, None, :]
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)


def flash_attention_qvec(q, k, v, qstart, scale=None):
    """Per-row-qstart causal attention; see flash_attention_qvec_plain."""
    if not build.use_kernel(q):
        return flash_attention_qvec_plain(q, k, v, qstart, scale)
    build.check_inputs("flash_attention_qvec", q, k, v)
    bh, tq, d = q.shape
    tk = k.shape[1]
    if (tuple(k.shape) != (bh, tk, d) or tuple(v.shape) != (bh, tk, d)
            or qstart.numel() != bh):
        raise ValueError("flash_attention_qvec: shapes q %s k %s v %s qstart "
                         "%s" % (tuple(q.shape), tuple(k.shape),
                                 tuple(v.shape), tuple(qstart.shape)))
    if d not in (64, 128):
        raise ValueError("flash_attention_qvec: the CUDA kernel is built for "
                         "head dims 64 and 128, got %d" % d)
    slices = -(-tk // KV_CHUNK) if tk > KV_CHUNK else 1
    if max(q.numel(), k.numel(), q.numel() * slices) >= 2 ** 31:
        raise ValueError("flash_attention_qvec: operands exceed the "
                         "kernel's 32-bit row indexing")
    if scale is None:
        scale = d ** -0.5
    qs = qstart.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    part_o = part_ml = None
    if slices > 1:
        part_o = torch.empty((bh, tq, slices, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((bh, tq, slices, 2), dtype=torch.float32,
                              device=q.device)
    build.launch("ptt_flash_attention_qvec", q, k, v, qs, out, part_o, part_ml,
                 bh, tq, tk, d, KV_CHUNK, float(scale))
    flash_attention_qvec.launches += 1
    return out


flash_attention_qvec.launches = 0
