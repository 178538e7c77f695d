"""fused_lstm and fused_gru: whole-sequence LSTM and GRU recurrences over
padded, already projected inputs, each one persistent CUDA kernel.

    fused_lstm(xproj [B, T, 4H], w [H, 4H], h0, c0 [B, H], lens [B])
        -> (hs, cs), each [B, T, H]; gate order i | f | c~ | o
    fused_gru(xproj [B, T, 3H], w [H, 3H], h0 [B, H], lens [B]) -> hs
        gates u | r | c, the reset applied before the recurrent product:
        c = tanh(x_c + (r h) W_c), h = u c + (1 - u) h_prev

A row b keeps its state at every t >= lens[b], so a row of length 0
outputs h0 (and c0) throughout and the last step is the last valid state.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``fused_lstm``
(``_lstm_seq_fwd``, kernel body ``_lstm_seq_kernel``) and ``fused_gru``
(``_gru_seq_fwd``, body ``_gru_seq_kernel``).  The CUDA kernels are
``csrc/recurrent.cu``.  ``lstm_seq_plain`` and ``gru_seq_plain`` are the
plain PyTorch versions, a loop over T mirroring the reference's
``_lstm_seq_dense`` and ``_gru_seq_dense``: CPU and meta tensors take
them, CUDA tensors launch the kernels.

Both are ``torch.autograd.Function``s (the reference's
``jax.custom_vjp``).  Their backward is the vjp of the plain scan,
recomputed from the inputs, as the reference's ``_lstm_vjp_bwd`` and
``_gru_vjp_bwd`` take the vjp of the dense scan: the JAX package has no
backward kernel for either, so on the card the backward is plain
PyTorch by design, not a fallback.
"""

import torch

from . import build

__all__ = ["fused_lstm", "fused_gru", "lstm_seq_plain", "gru_seq_plain",
           "lstm_cell"]


def lstm_cell(c_prev, h_prev, gates, forget_bias=0.0):
    """One LSTM cell update from [.., 4H] gates (i | f | c~ | o); returns
    (c, h).  The reference's ``nn_ops._lstm_cell``."""
    i, f, c_hat, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    o = torch.sigmoid(o)
    c = f * c_prev + i * torch.tanh(c_hat)
    return c, o * torch.tanh(c)


def _active(t, lens, like):
    return (t < lens).to(like.dtype)[:, None]


def lstm_seq_plain(xproj, w, h0, c0, lens):
    """(hs, cs) [B, T, H]: the masked scan of ``_lstm_seq_dense``."""
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xproj.shape[1]):
        c_new, h_new = lstm_cell(c, h, xproj[:, t] + h @ w)
        act = _active(t, lens, h)
        c = act * c_new + (1 - act) * c
        h = act * h_new + (1 - act) * h
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def gru_seq_plain(xproj, w, h0, lens):
    """hs [B, T, H]: the masked scan of ``_gru_seq_dense``."""
    hid = xproj.shape[-1] // 3
    w_uz, w_c = w[:, :2 * hid], w[:, 2 * hid:]
    h = h0
    hs = []
    for t in range(xproj.shape[1]):
        xt = xproj[:, t]
        gates = xt[:, :2 * hid] + h @ w_uz
        u = torch.sigmoid(gates[:, :hid])
        r = torch.sigmoid(gates[:, hid:])
        c = torch.tanh(xt[:, 2 * hid:] + (r * h) @ w_c)
        h_new = u * c + (1.0 - u) * h
        act = _active(t, lens, h)
        h = act * h_new + (1 - act) * h
        hs.append(h)
    return torch.stack(hs, 1)


def _check(name, gates, xproj, w, states, lens):
    build.check_inputs(name, xproj, w, *states)
    if xproj.dim() != 3 or xproj.shape[-1] % gates:
        raise ValueError("%s: xproj must be [B, T, %dH], got %s" % (
            name, gates, tuple(xproj.shape)))
    B, T, GH = xproj.shape
    H = GH // gates
    if tuple(w.shape) != (H, GH) or any(tuple(s.shape) != (B, H)
                                        for s in states):
        raise ValueError("%s: shapes xproj %s, w %s, states %s" % (
            name, tuple(xproj.shape), tuple(w.shape),
            [tuple(s.shape) for s in states]))
    if lens.numel() != B or lens.device != xproj.device:
        raise ValueError("%s: lens must be [B]=%d on %s" % (name, B,
                                                            xproj.device))
    if T == 0:
        raise ValueError("%s: T must be at least 1" % name)
    return B, T, H


def _launch(name, fn_name, B, T, H, *args):
    try:
        build.launch(fn_name, *args, B, T, H)
    except RuntimeError as e:
        raise RuntimeError(
            "%s at B %d, T %d, H %d: %s (the kernel keeps a block's W "
            "columns and one staged batch row in shared memory and needs "
            "every block co-resident)" % (name, B, T, H, e)) from e


def _lstm_forward(xproj, w, h0, c0, lens):
    if not build.use_kernel(xproj):
        return lstm_seq_plain(xproj, w, h0, c0, lens)
    B, T, H = _check("fused_lstm", 4, xproj, w, (h0, c0), lens)
    lens32 = lens.reshape(-1).to(torch.int32).contiguous()
    hs = torch.empty((B, T, H), dtype=torch.float32, device=xproj.device)
    cs = torch.empty_like(hs)
    _launch("fused_lstm", "ptt_lstm_seq", B, T, H, xproj, w, h0, c0, lens32,
            hs, cs)
    fused_lstm.launches += 1
    return hs, cs


def _gru_forward(xproj, w, h0, lens):
    if not build.use_kernel(xproj):
        return gru_seq_plain(xproj, w, h0, lens)
    B, T, H = _check("fused_gru", 3, xproj, w, (h0,), lens)
    lens32 = lens.reshape(-1).to(torch.int32).contiguous()
    hs = torch.empty((B, T, H), dtype=torch.float32, device=xproj.device)
    scratch = torch.empty((2, B, H), dtype=torch.float32,
                          device=xproj.device)  # r h and the update gate
    _launch("fused_gru", "ptt_gru_seq", B, T, H, xproj, w, h0, lens32, hs,
            scratch)
    fused_gru.launches += 1
    return hs


class _FusedLSTM(torch.autograd.Function):
    @staticmethod
    def forward(xproj, w, h0, c0, lens):
        return _lstm_forward(xproj, w, h0, c0, lens)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dhs, dcs):
        xproj, w, h0, c0, lens = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda x, w_, h_, c_: lstm_seq_plain(x, w_, h_, c_, lens),
            xproj, w, h0, c0)
        return (*vjp((dhs, dcs)), None)


class _FusedGRU(torch.autograd.Function):
    @staticmethod
    def forward(xproj, w, h0, lens):
        return _gru_forward(xproj, w, h0, lens)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dhs):
        xproj, w, h0, lens = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda x, w_, h_: gru_seq_plain(x, w_, h_, lens), xproj, w, h0)
        return (*vjp(dhs), None)


def fused_lstm(xproj, w, h0, c0, lens):
    """(hs, cs) [B, T, H] of the masked LSTM over xproj [B, T, 4H] (the
    CUDA kernel takes float32 contiguous tensors).  Differentiable in
    xproj, w, h0 and c0 (the plain scan's vjp)."""
    return _FusedLSTM.apply(xproj, w, h0, c0, lens)


def fused_gru(xproj, w, h0, lens):
    """hs [B, T, H] of the masked GRU over xproj [B, T, 3H].
    Differentiable in xproj, w and h0 (the plain scan's vjp)."""
    return _FusedGRU.apply(xproj, w, h0, lens)


fused_lstm.launches = 0
fused_gru.launches = 0
