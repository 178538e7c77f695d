"""Neural-net op lowerings (the counterpart of ``paddle_tpu/ops/nn_ops.py``),
limited to the ops of the serving slice, the KV-cached decode step, the
GPT-2 (with its modern-decoder options: rotary positions, SwiGLU) and
WMT Transformer training steps, the recurrent models (the stacked
LSTM classifier, the GRU seq2seq model) and the conv nets (ResNet, VGG,
SE-ResNeXt, the MNIST CNN).

Seven ops sit on hand-written kernels (``paddle_tpu_torch/kernels``):
``fc`` on ``matmul_bias_act``, ``fused_swiglu`` on ``matmul_swiglu``,
``fused_residual_ln`` on
``fused_add_layer_norm``, ``layer_norm`` over the last axis with Scale
and Bias on ``fused_layer_norm``, and ``fused_attention``: its per-row
QStart form on ``flash_attention_qvec``, its scalar-QStart form (the
chunked decode step, with or without a window) on
``flash_attention_piece`` and its forms without a QStart (causal or
not, with or without a key Bias, a sliding window or SegmentIds: the
packed causal LM) on ``flash_attention``, and the forward direction of
``padded_lstm`` and ``padded_gru`` on ``fused_lstm`` and ``fused_gru``.
Each wrapper takes its plain version for CPU and meta tensors and
launches its kernel for CUDA tensors.
``layer_norm``'s other forms are the reference's own XLA branch, which
has no kernel: they stay plain PyTorch on any device.

The conv family, the pooling ops and ``batch_norm`` reach no kernel of
the reference either (``lax.conv_general_dilated`` and plain ``jnp``):
here they run on ``torch.nn.functional``, so on cuDNN and PyTorch's own
CUDA kernels.  Their NHWC form (``data_format`` / ``data_layout``, set by
``transpiler.layout_transpiler.rewrite_nhwc``) permutes the [N, H, W, C]
tensor to an NCHW view with channels-last strides, runs the same call on
it, so that the library takes its channels-last kernels, and permutes
the result back; filters stay OIHW.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register
from ..kernels import (
    flash_attention,
    flash_attention_piece,
    flash_attention_qvec,
    fused_add_layer_norm,
    fused_gru,
    fused_layer_norm,
    fused_lstm,
    lstm_cell,
    matmul_bias_act,
    matmul_swiglu,
)
from .spmd_epilogue import (spmd_add_layer_norm, spmd_matmul_bias_act,
                            spmd_matmul_swiglu)


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
    act = attrs.get("activation_type", "") or ""
    out = spmd_matmul_bias_act(ctx, x2, w, bias, act)
    if out is None:
        out = matmul_bias_act(x2, w.contiguous(), bias, act)
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
    out = spmd_matmul_swiglu(ctx, x2, wg, wu)
    if out is None:
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
    x2, y2 = x.reshape(-1, h).contiguous(), y.reshape(-1, h).contiguous()
    gamma = ins["Scale"][0].reshape(h).contiguous()
    beta = ins["Bias"][0].reshape(h).contiguous()
    res = spmd_add_layer_norm(ctx, x2, y2, gamma, beta, eps)
    s2, o2, mean, var = (res if res is not None else
                         fused_add_layer_norm(x2, y2, gamma, beta, eps))
    lead = tuple(x.shape[:-1])
    return {"Sum": [s2.reshape(x.shape)], "Y": [o2.reshape(x.shape)],
            "Mean": [mean.reshape(lead)], "Variance": [var.reshape(lead)]}


@register("fused_attention")
def _fused_attention(ctx, ins, attrs):
    """Fused scaled-dot-product attention over [batch, heads, T, d].  The
    per-row QStart form (the ragged serving step) launches the
    flash_attention_qvec kernel on CUDA tensors, the scalar-QStart form
    (chunked decode: query i at global position QStart + i, keys at
    their cache indices, Tq != Tk; an optional window) the
    flash_attention_piece kernel, and the forms without a QStart (causal
    or not, with an optional key Bias, window and SegmentIds: [batch, T]
    ids, a query sees only keys of its own id) the flash_attention
    kernels."""
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
    if qstart is not None:
        # the ring's offset-causal piece is chunked decode: the piece is
        # softmax-normalized within its K/V, here the whole cache; the
        # reference's dense branch for large blocks is a VMEM limit of
        # the TPU, so every size takes the kernel
        out, _lse = flash_attention_piece(qf, kf, vf, True, float(scale),
                                          qstart, window)
        return {"Out": [out.reshape(b, h, t, d)]}
    kbias = None
    if ins.get("Bias"):
        kbias = ins["Bias"][0].reshape(b, tk).float()
        kbias = kbias[:, None, :].expand(b, h, tk).reshape(b * h, tk)
    seg = None
    if ins.get("SegmentIds"):
        # sequence packing: [B, T] ids, broadcast over the heads
        if t != tk:
            raise ValueError("fused_attention: SegmentIds requires Tq == Tk")
        seg = ins["SegmentIds"][0].reshape(b, t)
        seg = seg[:, None, :].expand(b, h, t).reshape(b * h, t)
    out = flash_attention(qf, kf, vf, kbias, causal, float(scale), window,
                          seg)
    return {"Out": [out.reshape(b, h, t, d)]}


@register("seq_cache_write", no_grad_inputs=("Pos",))
def _seq_cache_write(ctx, ins, attrs):
    """KV-cache update for incremental decode: the [B, H, W, D] chunk New
    lands in Cache [B, H, T, D] at time indices Pos .. Pos + W - 1 (W 1:
    the one-token step; W > 1: the chunked-prefill write).  Pos is
    clamped into [0, T - W], as the reference's dynamic_update_slice
    clamps its start: callers validate lengths up front
    (decode_cache.validate_cached_call).  The clamp and the indices are
    computed on the device, so the step does no host sync on Pos.

    The update is IN PLACE, as slot_cache_write's: Out aliases Cache,
    and the program's following ``assign(Out -> Cache)`` stores the same
    tensor back."""
    cache, new = ins["Cache"][0], ins["New"][0]
    if cache.device.type == "meta":
        return {"Out": [cache]}  # shape inference: Out is Cache's shape
    t_max, w = cache.shape[2], new.shape[2]
    if w > t_max:
        raise ValueError("seq_cache_write: width %d exceeds the cache's %d "
                         "time steps" % (w, t_max))
    pos = ins["Pos"][0].reshape(()).long().clamp(0, t_max - w)
    idx = pos + torch.arange(w, device=cache.device)
    cache.index_copy_(2, idx, new.to(cache.dtype))
    return {"Out": [cache]}


@register("decode_pos_mask", no_grad_inputs=("Pos",))
def _decode_pos_mask(ctx, ins, attrs):
    """[B, T] additive key bias for the one-token cached step: 0 at key
    positions <= Pos, -1e30 beyond (the rank-1 Bias of
    fused_attention)."""
    t, b = int(attrs["t_max"]), int(attrs["batch"])
    pos = ins["Pos"][0].reshape(())
    keys = torch.arange(t, device=pos.device)
    row = torch.where(keys <= pos, torch.zeros((), device=pos.device),
                      torch.full((), -1e30, device=pos.device))
    return {"Out": [row[None, :].expand(b, t).contiguous()]}


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


def _state(ins, slot, like, hid):
    """An initial state input, or zeros [B, H] (the reference's default)."""
    if ins.get(slot):
        return ins[slot][0].contiguous()
    return torch.zeros((like.shape[0], hid), dtype=like.dtype,
                       device=like.device)


def _lengths(seq_len, like):
    """[B] row lengths: SeqLen, or the full time axis."""
    if seq_len is not None:
        return seq_len.reshape(-1)
    return torch.full((like.shape[0],), like.shape[1], dtype=torch.int64,
                      device=like.device)


def _hold(m, new, old):
    """The reference's length mask: new where m is 1, old where 0."""
    return m * new + (1 - m) * old


@register("padded_lstm")
def _padded_lstm(ctx, ins, attrs):
    """LSTM over padded [B, T, 4H] projected input (Input), Weight
    [H, 4H], optional Bias [4H], SeqLen [B], H0 and C0 [B, H].  The
    forward direction runs fused_lstm (its kernel on CUDA tensors) on
    xproj + Bias, the bias folded in before the scan; masking holds the
    state past each row's length, so LastH/LastC are the last step.  The
    reverse direction is the reference's plain scan over the flipped
    time axis, the bias added inside each step, on any device (the
    reference has no kernel for it); LastH/LastC are its final carry."""
    xproj, w = ins["Input"][0], ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    bsz, t, h4 = xproj.shape
    hid = h4 // 4
    h0 = _state(ins, "H0", xproj, hid)
    c0 = _state(ins, "C0", xproj, hid)
    if not attrs.get("is_reverse", False):
        xg = xproj if b is None else xproj + b.reshape(1, 1, -1)
        hs, cs = fused_lstm(xg.contiguous(), w.contiguous(), h0, c0,
                            _lengths(seq_len, xproj))
        return {"Hidden": [hs], "CellSeq": [cs], "LastH": [hs[:, -1, :]],
                "LastC": [cs[:, -1, :]]}
    c, h = c0, h0
    hs, cs = [None] * t, [None] * t
    for ti in reversed(range(t)):
        gates = xproj[:, ti] + h @ w
        if b is not None:
            gates = gates + b
        c_new, h_new = lstm_cell(c, h, gates)
        if seq_len is not None:
            m = (ti < seq_len).to(h.dtype)[:, None]
            c_new, h_new = _hold(m, c_new, c), _hold(m, h_new, h)
        c, h = c_new, h_new
        hs[ti], cs[ti] = h, c
    return {"Hidden": [torch.stack(hs, 1)], "CellSeq": [torch.stack(cs, 1)],
            "LastH": [h], "LastC": [c]}


@register("padded_gru")
def _padded_gru(ctx, ins, attrs):
    """GRU over padded [B, T, 3H] projected input, Weight [H, 3H]
    (update | reset | candidate), optional SeqLen and H0.  The forward
    direction runs fused_gru (its kernel on CUDA tensors); the reverse
    direction is the reference's plain scan on any device."""
    xproj, w = ins["Input"][0], ins["Weight"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    bsz, t, h3 = xproj.shape
    hid = h3 // 3
    h0 = _state(ins, "H0", xproj, hid)
    if not attrs.get("is_reverse", False):
        hs = fused_gru(xproj.contiguous(), w.contiguous(), h0,
                       _lengths(seq_len, xproj))
        return {"Hidden": [hs], "LastH": [hs[:, -1, :]]}
    w_rz, w_c = w[:, :2 * hid], w[:, 2 * hid:]
    h = h0
    hs = [None] * t
    for ti in reversed(range(t)):
        x_t = xproj[:, ti]
        # gate layout [update|reset|state], h = u*c + (1-u)*h_prev
        u, r = torch.chunk(torch.sigmoid(x_t[:, :2 * hid] + h @ w_rz), 2,
                           dim=-1)
        c = torch.tanh(x_t[:, 2 * hid:] + (r * h) @ w_c)
        h_new = u * c + (1 - u) * h
        if seq_len is not None:
            h_new = _hold((ti < seq_len).to(h.dtype)[:, None], h_new, h)
        h = h_new
        hs[ti] = h
    return {"Hidden": [torch.stack(hs, 1)], "LastH": [h]}


# ---------------------------------------------------------------------------
# the conv nets: convolution, pooling, batch norm
# ---------------------------------------------------------------------------
def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


@contextlib.contextmanager
def cudnn_exact():
    """cuDNN's deterministic algorithms, picked by its heuristics: no
    autotuning, which a CUDA-graph capture cannot hold, and no atomics
    in the backward, so a captured step equals the eager one bit for
    bit.  TF32 stays as the process set it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def _to_nchw(x):
    """An NHWC tensor as an NCHW view with channels-last strides (an
    entry transpose's view is laid out first)."""
    return x.contiguous().permute(0, 3, 1, 2)


def _conv2d_impl(x, w, attrs, groups=None):
    groups = groups if groups is not None else attrs.get("groups", 1) or 1
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    out = F.conv2d(_to_nchw(x) if nhwc else x, w, None,
                   _pair(attrs.get("strides", [1, 1])),
                   _pair(attrs.get("paddings", [0, 0])),
                   _pair(attrs.get("dilations", [1, 1])), groups)
    return out.permute(0, 2, 3, 1) if nhwc else out


def _bias_shape(attrs, ndim=4):
    shape = [1] * ndim
    shape[1 if attrs.get("data_format", "NCHW") == "NCHW" else ndim - 1] = -1
    return shape


@register("conv2d", guard=cudnn_exact)
def _conv2d(ctx, ins, attrs):
    """With the reference's optional Bias and fuse_relu epilogue (relu
    as a maximum against 0, whose derivative is 0.5 at 0 as
    jnp.maximum's)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = _conv2d_impl(x, w, attrs)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(_bias_shape(attrs))
    if attrs.get("fuse_relu"):
        out = torch.maximum(out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))
    return {"Output": [out]}


@register("depthwise_conv2d", guard=cudnn_exact)
def _depthwise_conv2d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    ch = x.shape[1 if attrs.get("data_format", "NCHW") == "NCHW" else -1]
    out = _conv2d_impl(x, w, attrs, groups=ch)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(_bias_shape(attrs))
    return {"Output": [out]}


@register("pool2d")
def _pool2d(ctx, ins, attrs):
    """Max and avg pooling as the reference's reduce_window: padding is
    explicit (-inf for max, 0 for avg), and ceil_mode pads the right and
    bottom so that the window count rounds up, so a window may lie
    wholly in padding (-inf for max, NaN for exclusive avg; PyTorch's
    own ceil_mode would drop it).  Exclusive avg divides by the count of
    unpadded elements in each window.  Global pooling is amax / mean
    over H, W: amax's gradient splits ties evenly, as jnp.max's."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    paddings = _pair(attrs.get("paddings", [0, 0]))
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if attrs.get("global_pooling", False) or attrs.get("adaptive", False) \
            and list(attrs.get("ksize")) == [1, 1]:
        dims = (1, 2) if nhwc else (2, 3)
        out = (x.amax(dims, keepdim=True) if ptype == "max"
               else x.mean(dims, keepdim=True))
        return {"Out": [out]}
    if nhwc:
        x = _to_nchw(x)
    extra = [0, 0]
    if attrs.get("ceil_mode", False):
        for i, (dim, k, s, p) in enumerate(zip(x.shape[2:], ksize, strides,
                                               paddings)):
            rem = (dim + 2 * p - k) % s
            extra[i] = (s - rem) % s if rem else 0
    # F.pad's order: W's left and right, then H's
    pad = (paddings[1], paddings[1] + extra[1], paddings[0],
           paddings[0] + extra[0])
    padded = any(pad)
    if ptype == "max":
        xp = F.pad(x, pad, value=-math.inf) if padded else x
        out = F.max_pool2d(xp, ksize, strides)
    elif attrs.get("exclusive", True) and padded:
        summed = F.avg_pool2d(F.pad(x, pad), ksize, strides,
                              divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(F.pad(ones, pad), ksize, strides,
                              divisor_override=1)
        out = summed / counts
    else:
        out = F.avg_pool2d(F.pad(x, pad) if padded else x, ksize, strides)
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


@register("adaptive_pool2d")
def _adaptive_pool2d(ctx, ins, attrs):
    """The reference's form: NCHW, output sizes that divide H and W."""
    x = ins["X"][0]
    oh, ow = attrs["pooling_size"] if "pooling_size" in attrs \
        else attrs["ksize"]
    n, c, h, w = x.shape
    if h % oh or w % ow:
        raise ValueError("adaptive_pool2d needs output sizes that divide "
                         "the input's: %s into %s" % ((oh, ow), (h, w)))
    x = x.reshape(n, c, oh, h // oh, ow, w // ow)
    if attrs.get("pooling_type", "avg") == "max":
        return {"Out": [x.amax((3, 5))]}
    return {"Out": [x.mean((3, 5))]}


@register("batch_norm", no_grad_inputs=("Mean", "Variance"))
def _batch_norm(ctx, ins, attrs):
    """The reference's statistics, which are not PyTorch's: MeanOut = m
    Mean + (1 - m) batch mean (PyTorch's momentum is 1 - m), the biased
    batch variance for both the normalization and VarianceOut (PyTorch
    updates with the unbiased one), and SavedVariance the inverse std.
    So F.batch_norm computes Y alone and never sees the running stats in
    training; the statistics are var_mean's in float32, detached: no
    gradient reaches the running stats, and SavedMean, which the
    reference leaves differentiable, is read by no op, so the step's vjp
    does no work for it.  In test mode (is_test,
    use_global_stats) Y normalizes with the running stats, which pass
    through unchanged."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    m = attrs.get("momentum", 0.9)
    nhwc = attrs.get("data_layout", "NCHW") == "NHWC" and x.dim() > 2
    xs = x.float()
    if nhwc:  # channels last: an NC... view, channels-last strides
        xs = xs.contiguous().movedim(-1, 1)
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        y = F.batch_norm(xs, mean, var, scale, bias, False, 0.0, eps)
        saved_mean, inv = mean, torch.rsqrt(var + eps).detach()
        mean_out, var_out = mean, var
    else:
        y = F.batch_norm(xs, None, None, scale, bias, True, 0.0, eps)
        dims = [0] + list(range(2, xs.dim()))
        bvar, bmean = torch.var_mean(xs.detach(), dims, correction=0)
        saved_mean, inv = bmean, torch.rsqrt(bvar + eps)
        mean_out = m * mean + (1 - m) * bmean
        var_out = m * var + (1 - m) * bvar
    if nhwc:
        y = y.movedim(1, -1)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [saved_mean],
            "SavedVariance": [inv]}
