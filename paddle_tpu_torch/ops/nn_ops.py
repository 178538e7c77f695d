"""Neural-net op lowerings (the counterpart of ``paddle_tpu/ops/nn_ops.py``),
limited to the ops of the serving slice and the GPT-2 (with its
modern-decoder options: rotary positions, SwiGLU) and WMT Transformer
training steps.

Six ops sit on hand-written kernels (``paddle_tpu_torch/kernels``):
``fc`` on ``matmul_bias_act``, ``fused_swiglu`` on ``matmul_swiglu``,
``fused_residual_ln`` on
``fused_add_layer_norm``, ``layer_norm`` over the last axis with Scale
and Bias on ``fused_layer_norm``, ``fused_attention``'s per-row QStart
form on ``flash_attention_qvec`` and its forms without a QStart (causal
or not, with or without a key Bias) on ``flash_attention``.  Each
wrapper takes its plain version for CPU and meta tensors and launches
its kernel for CUDA tensors.  ``layer_norm``'s other forms are the
reference's own XLA branch, which has no kernel: they stay plain
PyTorch on any device.  The ``fused_attention`` forms whose reference
kernel is not ported yet (scalar QStart, sliding window, segment ids)
run their plain version on CPU and meta tensors and raise on a CUDA
tensor, so no plain path runs silently on the card.
"""

import numpy as np
import torch

from ..core.registry import register
from ..kernels import (
    NEG_INF,
    flash_attention,
    flash_attention_qvec,
    fused_add_layer_norm,
    fused_layer_norm,
    matmul_bias_act,
    matmul_swiglu,
)


def _not_on_cuda(t, what, item):
    if t.device.type == "cuda":
        raise NotImplementedError(
            "%s has no CUDA kernel yet (ROADMAP %s); it runs on CPU tensors "
            "only" % (what, item))


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """The kernel form, as in the reference: the norm over the last axis
    with both Scale and Bias.  Any other form is the reference's dense
    branch."""
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    if begin == x.dim() - 1 and ins.get("Scale") and ins.get("Bias"):
        h = x.shape[-1]
        y, mean, var = fused_layer_norm(
            x.reshape(-1, h).contiguous(),
            ins["Scale"][0].reshape(h).contiguous(),
            ins["Bias"][0].reshape(h).contiguous(), eps)
        lead = tuple(x.shape[:-1])
        return {"Y": [y.reshape(x.shape)], "Mean": [mean.reshape(lead)],
                "Variance": [var.reshape(lead)]}
    axes = tuple(range(begin, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = x.shape[begin:]
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(norm_shape).float()
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(norm_shape).float()
    # the statistics take no gradient, as in the reference
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.reshape(mean.shape[:begin]).detach()],
            "Variance": [var.reshape(var.shape[:begin]).detach()]}


@register("dropout")
def _dropout(ctx, ins, attrs):
    """Both implementations of the reference: downgrade_in_infer (train
    x * mask, test x (1 - p)) and upscale_in_train (train x / (1 - p) at
    kept positions, test x).  The keep mask is drawn from the run's
    generator for this op (``LowerCtx.rng``): the grad op's re-run of
    this rule sees the forward op's index and draws the same mask."""
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    keep = torch.rand(x.shape, generator=ctx.rng(attrs), device=x.device,
                      dtype=torch.float32) < (1.0 - p)
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    else:
        out = x * mask
    return {"Out": [out], "Mask": [mask]}


@register("fc")
def _fc(ctx, ins, attrs):
    """Fused fully-connected: mul + bias-add + activation in one op, on
    the matmul-epilogue kernel."""
    x, w = ins["Input"][0], ins["W"][0]
    k = int(attrs.get("in_num_col_dims", 1))
    x2 = x.reshape(int(np.prod(x.shape[:k])), -1).contiguous()
    bias = ins["Bias"][0].reshape(-1).contiguous() if ins.get("Bias") else None
    out = matmul_bias_act(x2, w.contiguous(), bias,
                          attrs.get("activation_type", "") or "")
    return {"Out": [out.reshape(tuple(x.shape[:k]) + (w.shape[-1],))]}


@register("fused_swiglu")
def _fused_swiglu(ctx, ins, attrs):
    """Fused SwiGLU gating (the target of swiglu_fuse_pass): silu(x @
    GateW) * (x @ UpW) on the matmul_swiglu kernel, X flattened to 2-D
    at x_num_col_dims.  The reference's VMEM gate (mm_epilogue_ok) has
    no counterpart: a shape the kernel cannot take raises."""
    x, wg, wu = ins["X"][0], ins["GateW"][0], ins["UpW"][0]
    k = int(attrs.get("x_num_col_dims", 1))
    x2 = x.reshape(int(np.prod(x.shape[:k])), -1).contiguous()
    out = matmul_swiglu(x2, wg.contiguous(), wu.contiguous())
    return {"Out": [out.reshape(tuple(x.shape[:k]) + (wg.shape[-1],))]}


@register("fused_residual_ln")
def _fused_residual_ln(ctx, ins, attrs):
    """Residual add + layer norm: the sum (the residual stream, kept
    under its original name), the normalized output and the row
    statistics in one kernel."""
    x, y = ins["X"][0], ins["Y"][0]
    eps = attrs.get("epsilon", 1e-5)
    h = x.shape[-1]
    s2, o2, mean, var = fused_add_layer_norm(
        x.reshape(-1, h).contiguous(), y.reshape(-1, h).contiguous(),
        ins["Scale"][0].reshape(h).contiguous(),
        ins["Bias"][0].reshape(h).contiguous(), eps)
    lead = tuple(x.shape[:-1])
    return {"Sum": [s2.reshape(x.shape)], "Y": [o2.reshape(x.shape)],
            "Mean": [mean.reshape(lead)], "Variance": [var.reshape(lead)]}


def _dense_attention(q, k, v, causal, scale, kbias=None, window=0, seg=None,
                     qoff=None):
    """Plain attention over [BH, T, d] (the reference's _dense_attention):
    the CPU path of the fused_attention forms without a CUDA kernel."""
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    neg = torch.full((), NEG_INF, device=q.device)
    if kbias is not None:
        s = s + kbias[:, None, :].float()
    if seg is not None:
        s = torch.where(seg[:, :, None] == seg[:, None, :], s, neg)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        base = 0 if qoff is None else qoff.reshape(()).long()
        q_pos = base + torch.arange(tq, device=q.device)
        k_pos = torch.arange(tk, device=q.device)
        keep = q_pos[:, None] >= k_pos[None, :]
        if window:
            keep = keep & (q_pos[:, None] - k_pos[None, :] < int(window))
        s = torch.where(keep[None], s, neg)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)


@register("fused_attention")
def _fused_attention(ctx, ins, attrs):
    """Fused scaled-dot-product attention over [batch, heads, T, d].  The
    per-row QStart form (the ragged serving step) launches the
    flash_attention_qvec kernel on CUDA tensors, and the forms without a
    QStart, window or segment ids (causal or not, with an optional key
    Bias) the flash_attention kernels."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    causal = bool(attrs.get("causal", False))
    window = int(attrs.get("window", 0) or 0)
    if window < 0:
        raise ValueError("fused_attention: window must be >= 0")
    if window and not causal:
        raise ValueError("fused_attention: window requires causal=True")
    scale = attrs.get("scale") or 1.0 / (q.shape[-1] ** 0.5)
    b, h, t, d = q.shape
    tk = k.shape[2]
    qstart = None
    if ins.get("QStart"):
        qstart = ins["QStart"][0].reshape(-1)
        # one base for every row is the scalar form; with one batch row
        # (a one-slot serving pool) the per-row form computes the same
        # thing and stays on the qvec kernel
        if qstart.shape[0] == 1 and (b > 1 or window):
            qstart = qstart.reshape(())
    if qstart is not None:
        if not causal:
            raise ValueError("fused_attention: QStart requires causal=True")
        if ins.get("Bias") or ins.get("SegmentIds"):
            raise ValueError(
                "fused_attention: QStart owns the causal cutoffs — "
                "Bias/SegmentIds are not combinable with it")
    elif causal and t != tk:
        raise ValueError("fused_attention: causal requires Tq == Tk, got %d "
                         "vs %d" % (t, tk))
    qf = q.reshape(b * h, t, d).contiguous()
    kf = k.reshape(b * h, tk, d).contiguous()
    vf = v.reshape(b * h, tk, d).contiguous()
    if qstart is not None and qstart.dim() > 0:
        if int(qstart.shape[0]) != b:
            raise ValueError(
                "fused_attention: vector QStart must be [batch]=%d, got %s"
                % (b, tuple(qstart.shape)))
        if window:
            raise ValueError("fused_attention: window is not supported with "
                             "per-row QStart")
        # each head row carries its batch row's base
        qsv = qstart[:, None].expand(b, h).reshape(b * h)
        out = flash_attention_qvec(qf, kf, vf, qsv, float(scale))
        return {"Out": [out.reshape(b, h, t, d)]}
    kbias = None
    if ins.get("Bias"):
        kbias = ins["Bias"][0].reshape(b, tk).float()
        kbias = kbias[:, None, :].expand(b, h, tk).reshape(b * h, tk)
    if qstart is None and not window and not ins.get("SegmentIds"):
        out = flash_attention(qf, kf, vf, kbias, causal, float(scale))
        return {"Out": [out.reshape(b, h, t, d)]}
    _not_on_cuda(q, "fused_attention with a scalar QStart, a window or "
                 "segment ids (kernels flash_attention_piece, "
                 "flash_attention's window and segment forms)",
                 "B9, B3-window/segments")
    seg = None
    if ins.get("SegmentIds"):
        if t != tk:
            raise ValueError("fused_attention: SegmentIds requires Tq == Tk")
        seg = ins["SegmentIds"][0].reshape(b, t)
        seg = seg[:, None, :].expand(b, h, t).reshape(b * h, t)
    out = _dense_attention(qf, kf, vf, causal, float(scale), kbias,
                           window=window, seg=seg, qoff=qstart)
    return {"Out": [out.reshape(b, h, t, d)]}


@register("slot_cache_write")
def _slot_cache_write(ctx, ins, attrs):
    """Per-row ragged KV-cache update: New [B, H, W, D] into Cache
    [B, H, T, D], row b's column i landing at time index Pos[b] + i for
    i < Width[b] only.  Invalid columns (beyond Width, or past the
    cache) are DROPPED, never clamped: a clamp would overwrite a
    neighbour request's live keys.

    The update is IN PLACE: Out aliases Cache.  The reference writes a
    fresh functional array and relies on buffer donation to make the
    cache update in place; here the program's following
    ``assign(Out -> Cache)`` stores the same tensor back.  Nothing reads
    the pre-write cache after this op in the programs that use it.

    The drop needs no host sync to filter the columns: column i of row b
    targets time index (Pos[b] + i) mod T.  A row's W targets are W
    consecutive integers mod T, so they are distinct (W <= T), and a
    valid column targets its own index.  An invalid column therefore
    lands on a cell no other column of its row writes, and rewrites the
    value already there.
    """
    cache, new = ins["Cache"][0], ins["New"][0]
    if cache.device.type == "meta":
        return {"Out": [cache]}  # shape inference: Out is Cache's shape
    pos = ins["Pos"][0].reshape(-1).long()
    width = ins["Width"][0].reshape(-1).long()
    b, h, t_max, d = cache.shape
    w = new.shape[2]
    if w > t_max:
        raise ValueError("slot_cache_write: width %d exceeds the cache's %d "
                         "time steps" % (w, t_max))
    col = torch.arange(w, device=cache.device)
    idx = pos[:, None] + col[None, :]  # [B, W]
    valid = (col[None, :] < width[:, None]) & (idx < t_max) & (idx >= 0)
    index = idx.remainder(t_max)[:, None, :, None].expand(b, h, w, d)
    kept = cache.gather(2, index)
    vals = torch.where(valid[:, None, :, None], new.to(cache.dtype), kept)
    cache.scatter_(2, index, vals)
    return {"Out": [cache]}


@register("rotary_embed", no_grad_inputs=("Pos",))
def _rotary_embed(ctx, ins, attrs):
    """Rotary position embedding (rotate-half) of per-head projections X
    [B, H, T, Dh].  Pos: none (positions arange(T)), [T], or per-row
    [B, T] (the ragged serving step: each slot at its own positions).
    freq and the angles are float32 in the reference's order, freq =
    base ** (-arange(half) / half), then pos * freq: at positions in the
    thousands the angle's float32 rounding is ~1e-4 rad, so the order is
    part of the result."""
    x = ins["X"][0]
    base = float(attrs.get("base", 10000.0))
    if x.shape[-1] % 2:
        raise ValueError("rotary_embed: head dim must be even (rotate-half "
                         "pairs), got %d" % x.shape[-1])
    half = x.shape[-1] // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    freq = base ** (-torch.arange(half, **f32) / half)
    pos = ins["Pos"][0] if ins.get("Pos") else None
    if pos is not None and pos.dim() == 2:
        ang = pos.to(torch.float32)[:, :, None] * freq  # [B, T, half]
        sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    else:
        pos = (torch.arange(x.shape[2], **f32) if pos is None
               else pos.reshape(-1).to(torch.float32))
        ang = pos[:, None] * freq  # [T, half]
        sin, cos = torch.sin(ang), torch.cos(ang)
    sin, cos = sin.to(x.dtype), cos.to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return {"Out": [torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                              -1)]}
