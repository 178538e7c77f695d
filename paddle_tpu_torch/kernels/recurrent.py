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

The kernels' geometry is ``rnn_plan``, a function of the shape alone, so
a shape sums every gate in one order on any card.

Both are ``torch.autograd.Function``s (the reference's
``jax.custom_vjp``).  Their backward is the vjp of the plain scan,
recomputed from the inputs, as the reference's ``_lstm_vjp_bwd`` and
``_gru_vjp_bwd`` take the vjp of the dense scan: the JAX package has no
backward kernel for either, so on the card the backward is plain
PyTorch by design, not a fallback.
"""

import collections

import torch

from . import build

__all__ = ["fused_lstm", "fused_gru", "lstm_seq_plain", "gru_seq_plain",
           "lstm_cell", "rnn_plan"]

MAX_BLOCKS = 132    # the H100 SXM's SMs: one block of units an SM, all resident
MAX_THREADS = 256   # a block's threads: 32 x k_warps x n_warps
REG_K_STEPS = 8     # 8-deep k-steps a warp holds in registers (the register form)
WARP_N_TILES = 2    # 8-column n-tiles a warp takes in one product
PASS_ROWS = 32      # batch rows a pass takes: two 16-row m-tiles
SMEM_MAX = 232448   # dynamic shared memory a block can opt in to
COUNTER_WORDS = 64  # the barrier counter's 256 bytes ahead of the exchange

# The kernels' geometry: each block owns `units` hidden units (all their
# gate columns); its k_warps x n_warps warps split K = H into slices of
# k_steps x 8 and the columns into pairs of n-tiles; a pass takes `rows`
# batch rows; regs: W in registers (else in shared memory); smem: bytes.
RnnPlan = collections.namedtuple(
    "RnnPlan", "units k_warps n_warps k_steps rows regs smem")


def _cdiv(a, b):
    return -(-a // b)


def _pad_to(n, mod, rem):
    """n padded up to the next value that is `rem` modulo `mod`."""
    return n + (rem - n) % mod


def _n_tiles(units, gates):
    """8-column n-tiles of each product: the LSTM's one over its 4 gates;
    the GRU's u|r product and its candidate product."""
    if gates == 4:
        return (_cdiv(4 * units, 8), 0)
    return (_cdiv(2 * units, 8), _cdiv(units, 8))


def _smem(B, gates, units, k_warps, k_steps, rows):
    """recurrent.cu's layout(): W as k pairs, the h tile, the partials, the
    x slice, the block's own state and the lengths, in bytes."""
    nts = _n_tiles(units, gates)
    kp = k_warps * k_steps * 8
    floats = (kp * _pad_to(8 * sum(nts), 8, 4)
              + rows * _pad_to(kp, 16, 8)
              + k_warps * rows * _pad_to(8 * max(nts), 16, 8)
              + B * gates * units + 2 * B * units + B)
    return 4 * floats


def rnn_plan(B, H, gates):
    """The recurrent kernels' plan for B rows of hidden size H with 4 (LSTM)
    or 3 (GRU) gates: a pure function of the shape (never of the card's SM
    count or the data), so every h element sums in one fixed order.

    units = ceil(H / 132): at most 132 blocks, each owning `units` hidden
    units.  W sits in registers, split once, where every warp's slice
    fits REG_K_STEPS k-steps and two slots (H <= 512): then H / 64 warps
    (rounded up) each take 8 k-steps, past H as zero W.  Else W sits in
    shared memory and about 8 warps split K into k_steps of 8 (an LSTM
    block wider than 2 n-tiles adds warps along N).  A pass takes up to 32
    rows (16 where shared memory runs short).  Raises ValueError for an H
    whose W slice and tiles do not fit in a block's shared memory."""
    if gates not in (3, 4) or H < 1 or B < 0:
        raise build.KernelInputError("rnn_plan: B %d, H %d, gates %d"
                                     % (B, H, gates))
    units = _cdiv(H, MAX_BLOCKS)
    nts = _n_tiles(units, gates)
    n_warps = _cdiv(max(nts), WARP_N_TILES)
    regs = int(H <= 8 * REG_K_STEPS * MAX_THREADS // 32 and (
        n_warps == 1 if gates == 4 else nts == (1, 1)))
    if regs:  # every warp takes REG_K_STEPS k-steps, zero W past H
        k_warps, k_steps = _cdiv(H, 8 * REG_K_STEPS), REG_K_STEPS
    else:
        k_warps = min(MAX_THREADS // 32 // n_warps, _cdiv(H, 8))
        k_steps = _cdiv(_cdiv(H, k_warps), 8)
        k_warps = _cdiv(H, 8 * k_steps)
    for rows in (min(PASS_ROWS, 16 * max(1, _cdiv(B, 16))), 16):
        smem = _smem(B, gates, units, k_warps, k_steps, rows)
        if smem <= SMEM_MAX:
            return RnnPlan(units, k_warps, n_warps, k_steps, rows, regs, smem)
    raise build.KernelInputError(
        "rnn_plan: B %d, H %d does not fit the recurrent kernel: a block's W "
        "columns ([%d, %d]) and tiles need %d bytes of shared memory, more "
        "than %d" % (B, H, H, gates * units, smem, SMEM_MAX))


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
        raise build.KernelInputError("%s: xproj must be [B, T, %dH], got %s"
                                     % (name, gates, tuple(xproj.shape)))
    B, T, GH = xproj.shape
    H = GH // gates
    if tuple(w.shape) != (H, GH) or any(tuple(s.shape) != (B, H)
                                        for s in states):
        raise build.KernelInputError("%s: shapes xproj %s, w %s, states %s" % (
            name, tuple(xproj.shape), tuple(w.shape),
            [tuple(s.shape) for s in states]))
    if lens.numel() != B or lens.device != xproj.device:
        raise build.KernelInputError("%s: lens must be [B]=%d on %s"
                                     % (name, B, xproj.device))
    if T == 0:
        raise build.KernelInputError("%s: T must be at least 1" % name)
    return B, T, H


def _workspace(B, H, device):
    """The launch's exchange [2, B, hp] (hp = H rounded up to 4) and its
    barrier counter, fresh zeros every launch, so no arrival of an
    earlier launch releases a waiter.  The counter has 256 bytes to
    itself: sharing an L2 sector with the exchange's first row, whose h
    every block writes and reads each step, cost its meeting ~1.6 us (a
    B11 launch at [32, 64, 4 x 512] 0.43 ms against 0.33)."""
    ws = torch.zeros(COUNTER_WORDS + 2 * B * 4 * _cdiv(H, 4),
                     dtype=torch.float32, device=device)
    return ws[COUNTER_WORDS:], ws[:COUNTER_WORDS]


def _launch(name, fn_name, B, T, H, plan, *args):
    try:
        build.launch(fn_name, *args, B, T, H, *plan)
    except RuntimeError as e:
        raise build.KernelError(
            "%s at B %d, T %d, H %d (plan %s): %s (the kernel needs every "
            "block of the plan co-resident)" % (name, B, T, H, tuple(plan),
                                                e)) from e


def _lstm_forward(xproj, w, h0, c0, lens):
    if not build.use_kernel(xproj):
        return lstm_seq_plain(xproj, w, h0, c0, lens)
    B, T, H = _check("fused_lstm", 4, xproj, w, (h0, c0), lens)
    plan = rnn_plan(B, H, 4)
    lens32 = lens.reshape(-1).to(torch.int32).contiguous()
    hs = torch.empty((B, T, H), dtype=torch.float32, device=xproj.device)
    cs = torch.empty_like(hs)
    xch, counter = _workspace(B, H, xproj.device)
    _launch("fused_lstm", "ptt_lstm_seq", B, T, H, plan, xproj, w, h0, c0,
            lens32, hs, cs, xch, counter)
    fused_lstm.launches += 1
    return hs, cs


def _gru_forward(xproj, w, h0, lens):
    if not build.use_kernel(xproj):
        return gru_seq_plain(xproj, w, h0, lens)
    B, T, H = _check("fused_gru", 3, xproj, w, (h0,), lens)
    plan = rnn_plan(B, H, 3)
    lens32 = lens.reshape(-1).to(torch.int32).contiguous()
    hs = torch.empty((B, T, H), dtype=torch.float32, device=xproj.device)
    xch, counter = _workspace(B, H, xproj.device)  # h and r h
    _launch("fused_gru", "ptt_gru_seq", B, T, H, plan, xproj, w, h0, lens32,
            hs, xch, counter)
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
