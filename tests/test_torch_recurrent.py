"""The port's recurrent slice on the CPU, held against the reference:

- the plain versions of fused_lstm (B11) and fused_gru (B10) and their
  autograd wrappers against the reference's Pallas kernels in interpret
  mode, forward and vjp (x, W, h0, c0), with ragged lengths, a row of
  length 0 and nonzero initial states; the wrappers' dispatch (CPU and
  meta tensors take the plain version without counting a launch, a
  CUDA tensor launches or raises);
- the lowerings this slice adds and their ``<op>_grad``s against the
  reference's ``lower`` and ``lower_grad_op``: padded_lstm and
  padded_gru in both directions with and without SeqLen / H0 / C0 /
  Bias, sequence_pool's six types (MAX with a tie), cross_entropy with
  hard and soft labels, top_k, accuracy, reduce_mean, log, concat, and
  fc over several inputs (mul + sum);
- build_stacked_lstm_train, build_seq2seq_train (each with Adam) and
  build_decode_step against the reference's programs, op for op;
- five Adam steps of a narrow stacked LSTM and a narrow seq2seq model
  from the reference's startup weights against the reference's losses
  and updated parameters;
- one BeamSearchDecoder run over the narrow decode step against the
  reference's: every step's log-probs within 1e-5 of their largest
  magnitude, the same tokens and scores.

Tolerances: forward values rtol = atol = 1e-5 and gradients 1e-4, as the
reference's own kernel tests (tests/test_pallas_kernels.py) hold its
kernels to the dense scan; lowerings rtol = atol = 1e-5 (summation order
only); losses rtol 1e-5; parameters and Adam moments within 1e-5 of each
tensor's largest magnitude.  The reference runs its dense lowerings:
FLAGS_use_pallas is off by default, so its padded_lstm / padded_gru take
the scan, and its kernels are run directly in interpret mode above."""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.contrib.decoder import BeamSearchDecoder as RefBeam
from paddle_tpu.core.registry import LowerCtx as RefCtx
from paddle_tpu.core.registry import lower_grad_op as ref_grad
from paddle_tpu.models import machine_translation as ref_mt
from paddle_tpu.models import stacked_dynamic_lstm as ref_sl
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as ptt
import paddle_tpu_torch.optimizer  # noqa: F401  (ptt.optimizer)
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.contrib.decoder import BeamSearchDecoder
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.core.registry import LowerCtx, lower_grad_op
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.kernels import (
    build,
    fused_gru,
    fused_lstm,
    gru_seq_plain,
    lstm_cell,
    lstm_seq_plain,
)
from paddle_tpu_torch.kernels.recurrent import rnn_plan
from paddle_tpu_torch.models import machine_translation as port_mt
from paddle_tpu_torch.models import stacked_dynamic_lstm as port_sl

from test_torch_kernels import _tf32_rna
from test_torch_ops import _check, _grad_attrs, _run_both
from test_torch_program import _assert_same_program

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh port programs, scope and name counters per test."""
    old_main = framework.switch_main_program(framework.Program())
    old_startup = framework.switch_startup_program(framework.Program())
    old_gen = unique_name.switch()
    old_scope = scope_mod._switch_scope(scope_mod.Scope())
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    scope_mod._switch_scope(old_scope)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the kernels' plain versions and autograd wrappers against Pallas
# ---------------------------------------------------------------------------
B, T, H = 4, 6, 8


def _seq_inputs(gates, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, gates * H).astype("float32")
    w = (rng.randn(H, gates * H) * 0.3).astype("float32")
    h0 = rng.randn(B, H).astype("float32")
    c0 = rng.randn(B, H).astype("float32")
    dh = rng.randn(B, T, H).astype("float32")
    dc = rng.randn(B, T, H).astype("float32")
    return x, w, h0, c0, dh, dc


@pytest.mark.parametrize("lens", [[6, 4, 2, 6], [6, 0, 3, 1]])
def test_fused_lstm_matches_reference_kernel(lens):
    """hs, cs and their vjp in x, W, h0 and c0 against pk.fused_lstm
    (interpret mode) under jax.vjp; rows of length 0 hold h0 and c0."""
    x, w, h0, c0, dh, dc = _seq_inputs(4, 31)
    lens = np.array(lens, "int32")
    (r_hs, r_cs), vjp = jax.vjp(
        lambda a, b, c, d: pk.fused_lstm(a, b, c, d, jnp.asarray(lens)),
        *map(jnp.asarray, (x, w, h0, c0)))
    r_grads = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    (hs, cs), vjp_t = torch.func.vjp(
        lambda a, b, c, d: fused_lstm(a, b, c, d, _t(lens.astype("int64"))),
        _t(x), _t(w), _t(h0), _t(c0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(r_hs), **TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(r_cs), **TOL)
    for got, want in zip(vjp_t((_t(dh), _t(dc))), r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    p_hs, p_cs = lstm_seq_plain(_t(x), _t(w), _t(h0), _t(c0), _t(lens))
    np.testing.assert_array_equal(p_hs.numpy(), hs.numpy())
    np.testing.assert_array_equal(p_cs.numpy(), cs.numpy())
    for b, n in enumerate(lens):
        # past its length a row holds its last state (h0, c0 at length 0)
        last_h = h0[b] if n == 0 else hs.numpy()[b, n - 1]
        np.testing.assert_array_equal(hs.numpy()[b, n:],
                                      np.broadcast_to(last_h, (T - n, H)))


@pytest.mark.parametrize("lens", [[6, 4, 2, 6], [6, 0, 3, 1]])
def test_fused_gru_matches_reference_kernel(lens):
    """hs and its vjp in x, W and h0 against pk.fused_gru (interpret
    mode) under jax.vjp."""
    x, w, h0, _, dh, _ = _seq_inputs(3, 32)
    lens = np.array(lens, "int32")
    r_hs, vjp = jax.vjp(
        lambda a, b, c: pk.fused_gru(a, b, c, jnp.asarray(lens)),
        *map(jnp.asarray, (x, w, h0)))
    r_grads = vjp(jnp.asarray(dh))
    hs, vjp_t = torch.func.vjp(
        lambda a, b, c: fused_gru(a, b, c, _t(lens)), _t(x), _t(w), _t(h0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(r_hs), **TOL)
    for got, want in zip(vjp_t(_t(dh)), r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    plain = gru_seq_plain(_t(x), _t(w), _t(h0), _t(lens))
    np.testing.assert_array_equal(plain.numpy(), hs.numpy())
    zero = [b for b, n in enumerate(lens) if n == 0]
    for b in zero:
        np.testing.assert_array_equal(hs.numpy()[b],
                                      np.broadcast_to(h0[b], (T, H)))


def test_single_step_with_initial_state_matches_reference_kernel():
    """T 1 with a nonzero h0 (the decode step's GRU) and h0, c0 (LSTM)."""
    x, w, h0, c0, _, _ = _seq_inputs(4, 33)
    lens = np.ones(B, "int32")
    r_hs, r_cs = pk.fused_lstm(*map(jnp.asarray, (x[:, :1], w, h0, c0, lens)))
    hs, cs = fused_lstm(_t(x[:, :1]), _t(w), _t(h0), _t(c0), _t(lens))
    np.testing.assert_allclose(hs.numpy(), np.asarray(r_hs), **TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(r_cs), **TOL)
    x3, w3 = x[:, :1, :3 * H].copy(), w[:, :3 * H].copy()
    r = pk.fused_gru(*map(jnp.asarray, (x3, w3, h0, lens)))
    np.testing.assert_allclose(
        fused_gru(_t(x3), _t(w3), _t(h0), _t(lens)).numpy(), np.asarray(r),
        **TOL)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_recurrent_wrappers_take_plain_path_without_counting(device):
    before = (fused_lstm.launches, fused_gru.launches)
    x = torch.ones(2, 3, 32, device=device)
    s = torch.ones(2, 8, device=device)
    lens = torch.full((2,), 3, device=device, dtype=torch.long)
    hs, cs = fused_lstm(x, torch.ones(8, 32, device=device), s, s, lens)
    out = fused_gru(x[..., :24], torch.ones(8, 24, device=device), s, lens)
    assert hs.device.type == cs.device.type == out.device.type == device
    assert hs.shape == cs.shape == out.shape == (2, 3, 8)
    assert (fused_lstm.launches, fused_gru.launches) == before


def test_recurrent_kernel_path_launches_or_raises(monkeypatch):
    """A tensor routed to the kernel path reaches the C entry point with
    int32 lengths and fresh outputs (the launch recorded here, not run),
    counts one launch, and keeps its grad_fn; malformed shapes and bf16
    raise before any launch; a failing launch raises with the shape."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: launched.append((name, args)))
    x = torch.ones(2, 3, 32, requires_grad=True)
    s = torch.zeros(2, 8)
    lens = torch.tensor([3, 0])
    before = (fused_lstm.launches, fused_gru.launches)
    hs, cs = fused_lstm(x, torch.ones(8, 32), s, s, lens)
    assert hs.grad_fn is not None and hs.shape == cs.shape == (2, 3, 8)
    out = fused_gru(torch.ones(2, 3, 24), torch.ones(8, 24), s, lens)
    assert out.shape == (2, 3, 8)
    assert [n for n, _ in launched] == ["ptt_lstm_seq", "ptt_gru_seq"]
    assert launched[0][1][4].dtype == torch.int32
    # B, T, H, then rnn_plan's seven ints, as build.SIGNATURES declares
    assert launched[0][1][-10:] == (2, 3, 8) + tuple(rnn_plan(2, 8, 4))
    assert launched[1][1][-10:] == (2, 3, 8) + tuple(rnn_plan(2, 8, 3))
    for (name, args), pointers in zip(launched, (9, 7)):
        assert len(args) == len(build.SIGNATURES[name]) - 1, name
        # the exchange and the barrier counter, zeroed for the launch
        assert all(a.abs().sum() == 0 for a in args[pointers - 2:pointers])
    assert (fused_lstm.launches, fused_gru.launches) == (before[0] + 1,
                                                         before[1] + 1)
    with pytest.raises(ValueError, match="shapes"):
        fused_lstm(x, torch.ones(8, 24), s, s, lens)
    with pytest.raises(ValueError, match="4H"):
        fused_lstm(torch.ones(2, 3, 30), torch.ones(8, 32), s, s, lens)
    with pytest.raises(ValueError, match="T must be"):
        fused_gru(torch.ones(2, 0, 24), torch.ones(8, 24), s, lens)
    with pytest.raises(TypeError, match="float32"):
        fused_gru(torch.ones(2, 3, 24, dtype=torch.bfloat16),
                  torch.ones(8, 24), s, lens)

    def refuse(name, *args):
        raise RuntimeError("%s: CUDA error 1 (invalid argument)" % name)

    monkeypatch.setattr(build, "launch", refuse)
    with pytest.raises(RuntimeError, match="B 2, T 3, H 8"):
        fused_gru(torch.ones(2, 3, 24), torch.ones(8, 24), s, lens)


# ---------------------------------------------------------------------------
# the kernels' plan and their arithmetic
# ---------------------------------------------------------------------------
def _registers(plan):
    """An upper estimate of a kernel thread's registers under `plan`:
    W's fragments in the register form (8 k-steps x 2 slots x 4 words),
    the accumulators (2 m-tiles x 2 n-tiles x 4), a split A fragment (8)
    and two B fragments being split (8), and 64 for addresses, indices
    and the epilogue.  ptxas reports the real count on the card
    (scripts/recurrent_kernel_check.py)."""
    return (64 if plan.regs else 0) + 16 + 8 + 8 + 64


def _pairs(plan, B, H):
    """How many times the kernel's blocks and passes under `plan` take each
    (row, unit) pair: block k owns units [k units, (k + 1) units) and walks
    the rows in passes of plan.rows."""
    seen = collections.Counter()
    for u0 in range(0, H, plan.units):
        for r0 in range(0, B, plan.rows):
            for b in range(r0, min(r0 + plan.rows, B)):
                for u in range(u0, min(u0 + plan.units, H)):
                    seen[b, u] += 1
    return seen


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("H", [16, 200, 512, 700])
@pytest.mark.parametrize("B", [1, 8, 32, 200])
def test_rnn_plan_covers_every_pair_once_and_fits_a_block(B, H, gates,
                                                          monkeypatch):
    """rnn_plan: every (row, unit) pair taken exactly once; K covered by
    the warps' slices with no warp idle; the n-tiles by the warps along N;
    at most 132 blocks of at most 256 threads; passes of 16 or 32 rows;
    the register estimate under 255 and the shared memory under 232,448
    bytes; W in registers exactly where its slices fit them (H <= 512).
    The plan asks nothing of a card: with every device query refusing, it
    is the same."""
    plan = rnn_plan(B, H, gates)
    seen = _pairs(plan, B, H)
    assert len(seen) == B * H and set(seen.values()) <= {1}
    assert -(-H // plan.units) <= 132
    kp = plan.k_warps * plan.k_steps * 8
    assert kp >= H > kp - plan.k_steps * 8
    n_tiles = (-(-4 * plan.units // 8),) if gates == 4 else (
        -(-2 * plan.units // 8), -(-plan.units // 8))
    assert 2 * (plan.n_warps - 1) < max(n_tiles) <= 2 * plan.n_warps
    assert 32 * plan.k_warps * plan.n_warps <= 256
    assert plan.rows in (16, 32) and (plan.rows == 16 or B > 16)
    assert _registers(plan) <= 255 and plan.smem <= 232448
    assert plan.regs == (H <= 512)

    def refuse(*args, **kw):
        raise AssertionError("rnn_plan asked the card")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert rnn_plan(B, H, gates) == plan


def test_rnn_plan_refuses_a_w_slice_past_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        rnn_plan(32, 2048, 4)
    with pytest.raises(ValueError, match="gates"):
        rnn_plan(32, 512, 2)


def _kernel_product(h, w_split, plan):
    """h [B, H] @ W [H, N] as the kernels sum it under `plan`: K padded
    to the warps' slices, each operand split into TF32 big + small
    (cvt.rna), each 8-deep k-step's three products (small x big, big x
    small, big x big) added in that order to the warp's float32
    accumulator over its k-steps in ascending k, and the warps' partials
    summed in warp order."""
    w_big, w_small = w_split
    B, H = h.shape
    kp = plan.k_warps * plan.k_steps * 8
    hp = torch.nn.functional.pad(h, (0, kp - H))
    h_big = _tf32_rna(hp)
    h_small = _tf32_rna(hp - h_big)
    steps = kp // 8

    def per_step(a, b):
        return torch.bmm(a.reshape(B, steps, 8).transpose(0, 1), b)

    prods = (per_step(h_small, w_big), per_step(h_big, w_small),
             per_step(h_big, w_big))
    total = None
    for kw in range(plan.k_warps):
        acc = torch.zeros(B, w_big.shape[-1])
        for ks in range(kw * plan.k_steps, (kw + 1) * plan.k_steps):
            for p in prods:
                acc = acc + p[ks]
        total = acc if total is None else total + acc
    return total


def _split_w(w, plan):
    kp = plan.k_warps * plan.k_steps * 8
    wp = torch.nn.functional.pad(w, (0, 0, 0, kp - w.shape[0]))
    big = _tf32_rna(wp)
    return (big.reshape(kp // 8, 8, -1),
            _tf32_rna(wp - big).reshape(kp // 8, 8, -1))


def _emulated_lstm(x, w, h0, c0, lens):
    B, T, _ = x.shape
    plan = rnn_plan(B, w.shape[0], 4)
    ws = _split_w(w, plan)
    h, c = h0, c0
    hs = []
    for t in range(T):
        g = x[:, t] + _kernel_product(h, ws, plan)
        c_new, h_new = lstm_cell(c, h, g)
        act = (t < lens)[:, None]
        c = torch.where(act, c_new, c)
        h = torch.where(act, h_new, h)
        hs.append(h)
    return torch.stack(hs, 1)


def _emulated_gru(x, w, h0, lens):
    B, T, H3 = x.shape
    H = H3 // 3
    plan = rnn_plan(B, H, 3)
    w_ur, w_c = _split_w(w[:, :2 * H], plan), _split_w(w[:, 2 * H:], plan)
    h = h0
    hs = []
    for t in range(T):
        g = x[:, t, :2 * H] + _kernel_product(h, w_ur, plan)
        u, r = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:])
        c = torch.tanh(x[:, t, 2 * H:] + _kernel_product(r * h, w_c, plan))
        h = torch.where((t < lens)[:, None], u * c + (1.0 - u) * h, h)
        hs.append(h)
    return torch.stack(hs, 1)


@pytest.mark.parametrize("kind,B,T,H", [
    ("lstm", 32, 64, 512), ("gru", 32, 50, 512), ("lstm", 8, 12, 64),
    ("gru", 8, 12, 64)])
def test_kernel_arithmetic_holds_the_reference_over_the_recurrence(kind, B,
                                                                   T, H):
    """The kernels' arithmetic emulated on the CPU (3xTF32 split products,
    the plan's K slices summed in warp order, the gates applied per step)
    through the paths' whole recurrences (64 LSTM steps, 50 GRU steps at
    B 32, H 512; and a narrow H 64, T 12) stays within 1e-5 absolute of
    the reference's dense scans (_lstm_seq_dense, _gru_seq_dense) with
    ragged lengths, a row of length 0 among them: the split's error does
    not grow through the recurrence."""
    gates = 4 if kind == "lstm" else 3
    rng = np.random.RandomState(50 + H + T)
    x = rng.randn(B, T, gates * H).astype("float32")
    w = (rng.randn(H, gates * H) / np.sqrt(H)).astype("float32")
    h0 = rng.randn(B, H).astype("float32")
    c0 = rng.randn(B, H).astype("float32")
    lens = rng.randint(0, T + 1, B)
    lens[0], lens[-1] = 0, T
    lens_t = torch.from_numpy(lens)
    if kind == "lstm":
        got = _emulated_lstm(_t(x), _t(w), _t(h0), _t(c0), lens_t)
        want, _ = pk._lstm_seq_dense(*map(jnp.asarray, (x, w, h0, c0)),
                                     jnp.asarray(lens))
    else:
        got = _emulated_gru(_t(x), _t(w), _t(h0), lens_t)
        want = pk._gru_seq_dense(*map(jnp.asarray, (x, w, h0)),
                                 jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# op lowerings and their grads
# ---------------------------------------------------------------------------
_R = np.random.RandomState(41)
_F = lambda *s: _R.randn(*s).astype("float32")  # noqa: E731
_LENS = np.array([5, 2, 0], "int64")


def _recurrent_case(op, gates, reverse, seq_len, h0, c0=False, bias=False):
    ins = {"Input": [_F(3, 5, gates * 4)],
           "Weight": [(_F(4, gates * 4) * 0.5)]}
    if bias:
        ins["Bias"] = [_F(gates * 4)]
    if seq_len:
        ins["SeqLen"] = [_LENS]
    if h0:
        ins["H0"] = [_F(3, 4)]
    if c0:
        ins["C0"] = [_F(3, 4)]
    outs = (["Hidden", "LastH", "LastC"] if op == "padded_lstm"
            else ["Hidden", "LastH"])
    return op, ins, {"is_reverse": reverse}, outs


_CASES = {}
for _rev in (False, True):
    for _sl in (False, True):
        tag = ("rev" if _rev else "fwd") + ("_seqlen" if _sl else "")
        _CASES["lstm_" + tag] = _recurrent_case("padded_lstm", 4, _rev, _sl,
                                                False, bias=True)
        _CASES["lstm_%s_states" % tag] = _recurrent_case(
            "padded_lstm", 4, _rev, _sl, True, c0=True)
        _CASES["gru_" + tag] = _recurrent_case("padded_gru", 3, _rev, _sl,
                                               False)
        _CASES["gru_%s_h0" % tag] = _recurrent_case("padded_gru", 3, _rev,
                                                    _sl, True)
_TIE = _F(3, 4, 2)
# a tie for the max of row 0's valid steps, in both features
_TIE[0, 1] = _TIE[0, 3] = _TIE[0, :4].max(0) + 0.5
for _p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
    _CASES["pool_" + _p.lower()] = (
        "sequence_pool", {"X": [_TIE], "SeqLen": [np.array([4, 2, 0])]},
        {"pooltype": _p}, ["Out"])
    _CASES["pool_%s_full" % _p.lower()] = (
        "sequence_pool", {"X": [_F(2, 3, 5)]}, {"pooltype": _p}, ["Out"])
_P = np.abs(_F(6, 5)) + 0.05
_P[2, 1] = 0.0  # a zero probability: the 1e-20 floor
_CASES.update({
    "cross_entropy_hard": ("cross_entropy",
                           {"X": [_P], "Label": [np.array(
                               [[0], [3], [1], [4], [2], [2]], "int64")]},
                           {"soft_label": False, "ignore_index": -100},
                           ["Y"]),
    "cross_entropy_soft": ("cross_entropy",
                           {"X": [_P], "Label": [np.abs(_F(6, 5))]},
                           {"soft_label": True, "ignore_index": -100}, ["Y"]),
    "log": ("log", {"X": [np.abs(_F(3, 4)) + 0.1]}, {}, ["Out"]),
    "concat": ("concat", {"X": [_F(2, 3, 4), _F(2, 3, 2)]}, {"axis": 2},
               ["Out"]),
    "concat_axis1": ("concat", {"X": [_F(2, 4), _F(2, 5), _F(2, 1)]},
                     {"axis": 1}, ["Out"]),
    "reduce_mean_keep": ("reduce_mean", {"X": [_F(2, 5, 4)]},
                         {"dim": [1], "keep_dim": True, "reduce_all": False},
                         ["Out"]),
})


@pytest.mark.parametrize("case", sorted(_CASES))
def test_recurrent_slice_lowering_matches_reference(case):
    op_type, ins, attrs, _ = _CASES[case]
    _check(op_type, ins, attrs)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_recurrent_slice_grad_matches_reference(case):
    """<op>_grad through the port's lower_grad_op against the reference's,
    with the same cotangents for the op's bound outputs; 1e-5."""
    op_type, ins, attrs, out_slots = _CASES[case]
    fwd, _ = _run_both(op_type, ins, attrs)
    rng = np.random.RandomState(42)
    cots = {s + "@GRAD": [rng.randn(*fwd[s][0].shape).astype("float32")]
            for s in out_slots}
    gattrs = _grad_attrs(op_type, attrs, ins, out_slots)
    gins = dict(ins, **cots)
    ref = ref_grad(RefCtx(), None,
                   {s: [jnp.asarray(a) for a in v] for s, v in gins.items()},
                   gattrs)
    out = lower_grad_op(LowerCtx(device="cpu"),
                        {s: [_t(np.asarray(a)) for a in v]
                         for s, v in gins.items()}, gattrs)
    assert set(out) == set(ref), (case, set(out), set(ref))
    for slot in ref:
        for a, b in zip(ref[slot], out[slot]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                       err_msg=slot)


def test_max_pool_splits_a_tie_as_the_reference():
    """Row 0's two equal maxima each take half of the gradient."""
    op_type, ins, attrs, _ = _CASES["pool_max"]
    cot = np.ones((3, 2), "float32")
    out = lower_grad_op(
        LowerCtx(device="cpu"),
        dict({s: [_t(a) for a in v] for s, v in ins.items()},
             **{"Out@GRAD": [_t(cot)]}),
        _grad_attrs(op_type, attrs, ins, ["Out"]))["X@GRAD"][0].numpy()
    np.testing.assert_array_equal(out[0], [[0, 0], [0.5, 0.5], [0, 0],
                                           [0.5, 0.5]])
    assert out[2].sum() == 0.0  # a row of length 0 takes none


def test_top_k_and_accuracy_match_reference():
    x = _F(7, 5)
    ref, out = _run_both("top_k", {"X": [x]}, {"k": 2})
    np.testing.assert_array_equal(out["Out"][0], ref["Out"][0])
    np.testing.assert_array_equal(out["Indices"][0], ref["Indices"][0])
    idx = out["Indices"][0]
    label = np.array([[idx[0, 0]], [idx[1, 1]], [9], [idx[3, 0]], [9], [9],
                      [idx[6, 1]]], "int64")
    ins = {"Out": [out["Out"][0]], "Indices": [idx], "Label": [label]}
    ref, out = _run_both("accuracy", ins, {})
    for slot in ("Accuracy", "Correct", "Total"):
        np.testing.assert_array_equal(out[slot][0],
                                      ref[slot][0].astype(out[slot][0].dtype))
    assert float(out["Accuracy"][0][0]) == pytest.approx(4 / 7)


def test_multi_input_fc_matches_reference():
    """fc over two inputs: a mul per input, the sum op, one bias; the same
    program and values as the reference's."""
    a_np, b_np = _F(3, 5, 4), _F(3, 5, 6)

    def build(pkg):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            a = pkg.layers.data("a", shape=[5, 4])
            b = pkg.layers.data("b", shape=[5, 6])
            out = pkg.layers.fc([a, b], size=7, num_flatten_dims=2,
                                act="tanh")
        return main, start, out

    r_main, r_start, r_out = build(fluid)
    p_main, p_start, p_out = build(ptt)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    assert [o.type for o in p_main.global_block().ops] == [
        "mul", "mul", "sum", "elementwise_add", "tanh"]
    feed = {"a": a_np, "b": b_np}
    r_scope, p_scope = fluid.Scope(), ptt.Scope()
    with fluid.scope_guard(r_scope):
        r_exe = fluid.Executor(fluid.CPUPlace())
        r_exe.run(r_start)
        init = {n: np.asarray(r_scope.find_var(n))
                for n, v in r_start.global_block().vars.items()
                if v.persistable}
        want = r_exe.run(r_main, feed=feed, fetch_list=[r_out])[0]
    with ptt.scope_guard(p_scope):
        params_from_numpy(init, p_scope, ptt.CPUPlace())
        got = ptt.Executor(ptt.CPUPlace()).run(p_main, feed=feed,
                                               fetch_list=[p_out])[0]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# programs op for op, five Adam steps, beam decode
# ---------------------------------------------------------------------------
LSTM_ARGS = dict(dict_size=61, seq_len_max=12, emb_dim=16, hidden_dim=16,
                 stacked_num=3, class_dim=2)
S2S_ARGS = dict(src_vocab=61, tgt_vocab=53, max_src=8, max_tgt=8,
                embed_dim=16, hidden_dim=16)
DEC_ARGS = dict(src_vocab=61, tgt_vocab=53, max_src=8, embed_dim=16,
                hidden_dim=16)


def _build(pkg, model, which, adam=True):
    """The builder's program under a fresh name generator, with Adam
    (lr 3e-3) on its loss; returns (main, startup, outputs)."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        if which == "lstm":
            out = model.build_stacked_lstm_train(**LSTM_ARGS)
        elif which == "s2s":
            out = model.build_seq2seq_train(**S2S_ARGS)
        else:
            out = model.build_decode_step(**DEC_ARGS)
        if adam:
            pkg.optimizer.Adam(3e-3).minimize(out[1])
    return main, start, out


_MODELS = {"lstm": (ref_sl, port_sl), "s2s": (ref_mt, port_mt),
           "decode": (ref_mt, port_mt)}


@pytest.mark.parametrize("which", ["lstm", "s2s", "decode"])
def test_recurrent_programs_match_reference(which):
    adam = which != "decode"
    ref, port = _MODELS[which]
    r_main, r_start, r_out = _build(fluid, ref, which, adam)
    p_main, p_start, p_out = _build(ptt, port, which, adam)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    types = [o.type for o in p_main.global_block().ops]
    if which == "lstm":
        assert types.count("padded_lstm") == 3
        assert types.count("padded_lstm_grad") == 3
        assert types.count("sequence_pool") == 2
        assert [o.attrs["is_reverse"] for o in p_main.global_block().ops
                if o.type == "padded_lstm"] == [False, True, False]
        assert {"sum", "accuracy", "top_k", "cross_entropy_grad"} <= set(types)
    else:
        assert types.count("padded_gru") == 2
        assert types.count("padded_gru_grad") == (2 if adam else 0)
    if adam:
        assert types.count("adam") == len(
            p_main.global_block().all_parameters())


def _feed(which, seed):
    rng = np.random.RandomState(seed)
    if which == "lstm":
        n, t = 4, LSTM_ARGS["seq_len_max"]
        return {"words": rng.randint(0, 61, (n, t)).astype("int64"),
                "seq_len": np.array([12, 7, 1, 10], "int64"),
                "label": rng.randint(0, 2, (n, 1)).astype("int64")}
    n, t = 4, S2S_ARGS["max_src"]
    return {"src_word_id": rng.randint(0, 61, (n, t)).astype("int64"),
            "target_language_word": rng.randint(0, 53, (n, t)).astype("int64"),
            "target_language_next_word": rng.randint(0, 53, (n, t)).astype(
                "int64")}


def _persistables(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


@pytest.mark.parametrize("which", ["lstm", "s2s"])
def test_recurrent_training_matches_reference_over_adam_steps(which):
    """Five Adam steps (lr 3e-3) from the reference's startup arrays,
    carried over as numpy: losses rtol 1e-5; every parameter and Adam
    moment within 1e-5 of its largest magnitude, and most moved."""
    ref, port = _MODELS[which]
    feed = _feed(which, 5)
    r_main, r_start, r_out = _build(fluid, ref, which)
    fetch = [r_out[1]] + ([r_out[2]] if which == "lstm" else [])
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(r_start)
        names = _persistables(r_start)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        r_runs = [[float(np.asarray(v).sum()) for v in exe.run(
            r_main, feed=feed, fetch_list=fetch)] for _ in range(5)]
        final = {n: np.asarray(scope.find_var(n)) for n in names}
    p_main, p_start, p_out = _build(ptt, port, which)
    p_fetch = [p_out[1]] + ([p_out[2]] if which == "lstm" else [])
    p_scope = ptt.Scope()
    with ptt.scope_guard(p_scope):
        params_from_numpy(init, p_scope, ptt.CPUPlace())
        p_exe = ptt.Executor(ptt.CPUPlace())
        runs = [[float(v.sum()) for v in p_exe.run(
            p_main, feed=feed, fetch_list=p_fetch)] for _ in range(5)]
    np.testing.assert_allclose(runs, r_runs, rtol=1e-5)
    losses = [r[0] for r in runs]
    assert len(set(losses)) == 5 and np.isfinite(losses).all()
    moved = 0
    for name, want in final.items():
        got = p_scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, name
        moved += not np.array_equal(want, init[name])
    assert moved > len(final) // 2


def _beam_run(pkg, beam_cls, exe, main, start_init, outs, src):
    """One beam search (beam 4 over 2 sentences, up to 6 steps) through
    `beam_cls` on the decode step `main`: (ids, scores, every step's
    log-probs)."""
    _, logp, new_h = outs
    scope = pkg.Scope()
    steps = []
    with pkg.scope_guard(scope):
        start_init(scope)

        def step_fn(tokens, states):
            lp, nh = exe.run(main, feed={
                "src_word_id": src,
                "cur_token": np.asarray(tokens).reshape(-1, 1).astype("int64"),
                "prev_hidden": np.asarray(states, "float32")},
                fetch_list=[logp, new_h])
            steps.append(np.asarray(lp))
            return np.asarray(lp), np.asarray(nh)

        dec = beam_cls(step_fn, 4, start_token=1, end_token=0, max_len=6)
        out, scores = dec.decode(2, init_states=np.zeros(
            (2 * 4, DEC_ARGS["hidden_dim"]), "float32"))
    return out, scores, steps


def test_beam_decode_matches_reference():
    """Beam 4 over 2 sentences, up to 6 steps, through each package's
    BeamSearchDecoder on its decode step (the GRU at T 1 from the
    previous hidden state, H0): the same tokens and scores, and every
    step's log-probs within 1e-5 of their largest magnitude."""
    r_main, r_start, r_outs = _build(fluid, ref_mt, "decode", adam=False)
    p_main, p_start, p_outs = _build(ptt, port_mt, "decode", adam=False)
    rng = np.random.RandomState(9)
    src = np.repeat(rng.randint(2, 61, (2, DEC_ARGS["max_src"])), 4,
                    axis=0).astype("int64")
    init = {}

    def ref_init(scope):
        fluid.Executor(fluid.CPUPlace()).run(r_start)
        init.update({n: np.asarray(scope.find_var(n))
                     for n in _persistables(r_start)})

    r_tok, r_scores, r_steps = _beam_run(
        fluid, RefBeam, fluid.Executor(fluid.CPUPlace()), r_main, ref_init,
        r_outs, src)
    p_tok, p_scores, p_steps = _beam_run(
        ptt, BeamSearchDecoder, ptt.Executor(ptt.CPUPlace()), p_main,
        lambda scope: params_from_numpy(init, scope, ptt.CPUPlace()), p_outs,
        src)
    assert len(p_steps) == len(r_steps) >= 2
    for got, want in zip(p_steps, r_steps):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-5 * scale
    np.testing.assert_array_equal(p_tok, r_tok)
    np.testing.assert_allclose(p_scores, r_scores, rtol=1e-5)
