"""paddle_tpu_torch kernels: each plain PyTorch version against the JAX
entry point it replaces, run as tests/test_pallas_kernels.py runs it
(Pallas interpret mode on the CPU), forward and, through the wrappers'
``torch.autograd.Function``s under ``torch.func.vjp``, backward against
the reference's ``jax.vjp``; plus the wrappers' dispatch rules: CPU and
meta tensors take the plain version without counting a launch, and the
kernel path raises rather than falling back.

Tolerance: rtol = atol = 1e-5 in float32 — the two sides sum in
different orders (XLA vs PyTorch CPU kernels), nothing else differs."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.kernels import (
    MM_ACTS,
    add_layer_norm_plain,
    build,
    flash_attention,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_fwd_rows,
    flash_attention_grad_plain,
    flash_attention_piece,
    flash_attention_piece_dkv,
    flash_attention_piece_dq,
    flash_attention_piece_fwd,
    flash_attention_piece_grad_plain,
    flash_attention_piece_plain,
    flash_attention_plain,
    flash_attention_qvec,
    flash_attention_qvec_dkv,
    flash_attention_qvec_dq,
    flash_attention_qvec_plain,
    fused_add_layer_norm,
    fused_layer_norm,
    fused_linear_xent,
    fused_softmax_xent,
    layer_norm_plain,
    linear_xent_dw,
    linear_xent_dx,
    linear_xent_fwd,
    linear_xent_grad_plain,
    linear_xent_plain,
    matmul_bias_act,
    matmul_bias_act_plain,
    matmul_swiglu,
    matmul_swiglu_plain,
    softmax_xent_bwd,
    softmax_xent_fwd,
    softmax_xent_grad_plain,
    softmax_xent_plain,
)

from paddle_tpu_torch.kernels import add_layer_norm as aln_mod
from paddle_tpu_torch.kernels import layer_norm as ln_mod
from paddle_tpu_torch.kernels import softmax_xent as sx_mod
from paddle_tpu_torch.kernels import matmul_epilogue as me
from paddle_tpu_torch.kernels.matmul_epilogue import SKINNY, TILED, mm_plan

# the module (the package exports a function of the same name)
fa_mod = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

TOL = dict(rtol=1e-5, atol=1e-5)


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
# matmul_bias_act
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("act", [a for a in MM_ACTS])
def test_matmul_bias_act_plain_matches_reference(act, with_bias):
    rng = np.random.RandomState(20)
    x = rng.randn(24, 40).astype("float32")
    w = (rng.randn(40, 48) * 0.2).astype("float32")
    b = rng.randn(48).astype("float32") if with_bias else None
    ref = pk.matmul_bias_act(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), act, 8, 48)
    out = matmul_bias_act_plain(_t(x), _t(w), None if b is None else _t(b),
                                act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_matmul_bias_act_plain_matches_reference_ragged_rows():
    """M not a multiple of any tile (7 rows), odd K and N."""
    rng = np.random.RandomState(21)
    x = rng.randn(7, 12).astype("float32")
    w = (rng.randn(12, 20) * 0.3).astype("float32")
    b = rng.randn(20).astype("float32")
    ref = pk.matmul_bias_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             "gelu", 1, 20)
    out = matmul_bias_act(_t(x), _t(w), _t(b), "gelu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_matmul_bias_act_unknown_activation_raises():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unsupported activation"):
        matmul_bias_act(x, torch.zeros(3, 4), None, "elu")


# ---------------------------------------------------------------------------
# fused_add_layer_norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows", [24, 7])
def test_add_layer_norm_plain_matches_reference(rows):
    rng = np.random.RandomState(24)
    x = rng.randn(rows, 32).astype("float32")
    y = rng.randn(rows, 32).astype("float32")
    g = (rng.rand(32) + 0.5).astype("float32")
    b = rng.randn(32).astype("float32")
    rs, ro = pk.fused_add_layer_norm(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(g), jnp.asarray(b), 1e-5,
                                     8 if rows % 8 == 0 else 1)
    s, o, mean, var = fused_add_layer_norm(_t(x), _t(y), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **TOL)
    # the row statistics the fused_residual_ln op outputs (the reference
    # lowering recomputes them from the sum)
    rsum = np.asarray(rs)
    assert mean.shape == var.shape == (rows,)
    np.testing.assert_allclose(mean.numpy(), rsum.mean(-1), **TOL)
    np.testing.assert_allclose(var.numpy(), rsum.var(-1), **TOL)
    plain = add_layer_norm_plain(_t(x), _t(y), _t(g), _t(b), 1e-5)
    for got, want in zip((s, o, mean, var), plain):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# flash_attention_qvec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tq,tk,qstarts", [
    (8, 16, [0, 3, 5, 8, 2, 7]),   # 8 = Tk - Tq
    (4, 16, [0, 6, 12, 12, 1, 9]),  # 0, mid-cache and Tk - Tq
])
def test_flash_attention_qvec_plain_matches_reference(tq, tk, qstarts):
    rng = np.random.RandomState(30)
    bh, d = len(qstarts), 8
    q = rng.randn(bh, tq, d).astype("float32")
    k = rng.randn(bh, tk, d).astype("float32")
    v = rng.randn(bh, tk, d).astype("float32")
    qs = np.array(qstarts, "int32")
    ref = pk.flash_attention_qvec(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(qs), None,
                                  tq, 8)
    out = flash_attention_qvec(_t(q), _t(k), _t(v), _t(qs.astype("int64")))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    plain = flash_attention_qvec_plain(_t(q), _t(k), _t(v), _t(qs))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


# ---------------------------------------------------------------------------
# wrapper dispatch: plain for CPU/meta without a launch; no fallback
# ---------------------------------------------------------------------------
def _calls(device):
    x = torch.ones(4, 64, device=device)
    g = torch.ones(64, device=device)
    yield lambda: fused_add_layer_norm(x, x, g, g)
    yield lambda: matmul_bias_act(x, torch.ones(64, 8, device=device),
                                  torch.ones(8, device=device), "gelu")
    q = torch.ones(2, 4, 64, device=device)
    yield lambda: flash_attention_qvec(q, q, q, torch.zeros(2, device=device,
                                                            dtype=torch.long))
    w = torch.ones(64, 10, device=device)
    lbl = torch.zeros(4, device=device, dtype=torch.long)
    row = torch.ones(4, 1, device=device)
    yield lambda: linear_xent_fwd(x, w, lbl, 0.1)
    yield lambda: linear_xent_dx(x, w, lbl, row, row, 0.1)
    yield lambda: linear_xent_dw(x, w, lbl, row, row, 0.1)
    yield lambda: fused_layer_norm(x, g, g)
    lse = torch.zeros(2, 4, device=device)
    kb = torch.zeros(2, 4, device=device)
    yield lambda: flash_attention_fwd(q, q, q, kb, True)
    yield lambda: flash_attention_dq(q, q, q, kb, lse, q, lse, True)
    yield lambda: flash_attention_dkv(q, q, q, None, lse, q, lse, False)
    yield lambda: matmul_swiglu(x, w, w)
    yield lambda: softmax_xent_fwd(x, lbl)
    yield lambda: softmax_xent_bwd(x, lbl, row)
    k = torch.ones(2, 6, 64, device=device)
    qoff = torch.full((1,), 2, device=device, dtype=torch.long)
    qs = torch.zeros(2, device=device, dtype=torch.long)
    yield lambda: flash_attention_piece_fwd(q, k, k, True, None, qoff)
    yield lambda: flash_attention_piece_dq(q, k, k, lse, q, lse, True, None,
                                           qoff)
    yield lambda: flash_attention_piece_dkv(q, k, k, lse, q, lse, True, None,
                                            qoff)
    yield lambda: flash_attention_qvec_dq(q, k, k, lse, q, lse, qs)
    yield lambda: flash_attention_qvec_dkv(q, k, k, lse, q, lse, qs)


_LAUNCHED = (fused_add_layer_norm, matmul_bias_act, flash_attention_qvec,
             linear_xent_fwd, linear_xent_dx, linear_xent_dw, fused_layer_norm,
             flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
             matmul_swiglu, softmax_xent_fwd, softmax_xent_bwd,
             flash_attention_piece_fwd, flash_attention_piece_dq,
             flash_attention_piece_dkv, flash_attention_qvec_dq,
             flash_attention_qvec_dkv)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_take_plain_path_without_counting(device):
    fns = _LAUNCHED
    before = [f.launches for f in fns]
    for call in _calls(device):
        out = call()
        out = out[0] if isinstance(out, tuple) else out
        assert out.device.type == device
    assert [f.launches for f in fns] == before


def test_kernel_path_raises_when_the_library_cannot_build(monkeypatch,
                                                         tmp_path):
    """A tensor routed to the kernel path with no buildable library
    raises — never a silent plain fallback."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/bin/nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    before = [f.launches for f in _LAUNCHED]
    for call in _calls("cpu"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert [f.launches for f in _LAUNCHED] == before


def test_declared_signatures_match_the_c_sources():
    """build.SIGNATURES (the ctypes argument types) against every
    `extern "C"` entry point in csrc: a pointer or stream is c_void_p,
    an int c_int, a float c_float, in order.  No compiler runs here, so
    this is what catches a drifted declaration before the card does."""
    import ctypes
    import os
    import re

    kinds = {}
    for path in build.sources():
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int (ptt_\w+)\(([^)]*)\)',
                                       src):
            kinds[name] = tuple(
                ctypes.c_void_p if ("*" in p or "cudaStream_t" in p)
                else ctypes.c_float if p.split()[0] == "float"
                else ctypes.c_int
                for p in (q.strip() for q in params.split(",")))
    assert set(kinds) == set(build.SIGNATURES), os.listdir(build.CSRC)
    for name, argtypes in build.SIGNATURES.items():
        assert kinds[name] == argtypes, name


def test_kernel_path_refuses_bf16_and_grad(monkeypatch):
    """The kernel path refuses bf16.  Grad is no longer refused: each
    wrapper is a torch.autograd.Function, so a tensor that requires grad
    reaches the launch (recorded here instead of run) and the result
    carries a grad_fn."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    x = torch.ones(4, 64, dtype=torch.bfloat16)
    g = torch.ones(64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        fused_add_layer_norm(x, x, g, g)
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: launched.append(name))
    w = torch.ones(64, 8, requires_grad=True)
    out = matmul_bias_act(torch.ones(4, 64), w, None, "")
    assert launched == ["ptt_matmul_bias_act"] and out.grad_fn is not None
    x = torch.ones(4, 64, requires_grad=True)
    gam = torch.ones(64, requires_grad=True)
    s, o, _, _ = fused_add_layer_norm(x, x, gam, gam)
    assert launched[-1] == "ptt_add_layer_norm" and o.grad_fn is not None
    loss = fused_linear_xent(x, torch.ones(64, 10, requires_grad=True),
                             torch.zeros(4, dtype=torch.long), 0.1)
    assert launched[-1] == "ptt_linear_xent_fwd" and loss.grad_fn is not None


# ---------------------------------------------------------------------------
# fused_linear_xent: forward, dx and dw against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,H,V,eps", [
    (16, 24, 10, 0.0),   # V not a multiple of the vocab tile (4)
    (16, 24, 10, 0.1),
    (20, 16, 50, 0.1),   # R not a multiple of the row tile (8)
    (13, 8, 33, 0.0),    # odd everything
])
def test_linear_xent_matches_reference_kernel(R, H, V, eps):
    """The plain version (loss, lse) and the autograd wrapper's (loss,
    dx, dw) against the reference's fused_linear_xent (Pallas interpret
    mode, block_r 8, block_v 4) under jax.vjp, with labels outside
    [0, V) in the batch.  rtol 1e-5, atol 1e-6."""
    rng = np.random.RandomState(27)
    x = rng.randn(R, H).astype("float32")
    w = (rng.randn(H, V) * 0.3).astype("float32")
    lbl = rng.randint(0, V, (R,)).astype("int64")
    lbl[1], lbl[5] = -1, V  # both outside the vocab: smoothing term only
    dy = rng.rand(R, 1).astype("float32")
    tol = dict(rtol=1e-5, atol=1e-6)

    loss_r, vjp = jax.vjp(
        lambda a, b: pk.fused_linear_xent(a, b, jnp.asarray(lbl, "int32"),
                                          eps, 8, 4),
        jnp.asarray(x), jnp.asarray(w))
    dx_r, dw_r = vjp(jnp.asarray(dy))
    dense = np.asarray(pk._linear_xent_dense(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(lbl, "int32"), eps))

    loss, lse = linear_xent_plain(_t(x), _t(w), _t(lbl), eps)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_r), **tol)
    np.testing.assert_allclose(loss.numpy(), dense, **tol)
    lg = x.astype("float64") @ w.astype("float64")
    np.testing.assert_allclose(
        lse.numpy()[:, 0], np.log(np.exp(lg).sum(-1)), **tol)

    xt, wt = _t(x), _t(w)
    out, vjp_t = torch.func.vjp(
        lambda a, b: fused_linear_xent(a, b, _t(lbl), eps), xt, wt)
    dx, dw = vjp_t(_t(dy))
    np.testing.assert_allclose(out.numpy(), np.asarray(loss_r), **tol)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_r), **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_r), **tol)
    gdx, gdw = linear_xent_grad_plain(xt, wt, _t(lbl), lse, _t(dy), eps)
    np.testing.assert_array_equal(gdx.numpy(), dx.numpy())
    np.testing.assert_array_equal(gdw.numpy(), dw.numpy())


# the training paths' (R, H, V): WMT, GPT-2, TinyLlama widths, BERT's MLM
# head, and B12's slabs (WMT on mp 2, TinyLlama widths on mp 4)
LXENT_PATH_SHAPES = [(4096, 512, 10000), (8192, 768, 50257),
                     (4096, 2048, 32000), (4096, 768, 30522),
                     (4096, 512, 5000), (4096, 2048, 8000)]


@pytest.mark.parametrize("R,H,V", [(64, h, 1000) for h in (
    8, 24, 256, 512, 600, 768, 776, 2048, 4096, 5000, 6144, 6145, 8192,
    65536)] + LXENT_PATH_SHAPES)
def test_lxent_plan_cuts_h_into_a_cluster(R, H, V):
    """The linear cross-entropy kernels' plan: n slices of HS (a cluster
    of n blocks along H in dx / dw), n <= 8 (the portable cluster size),
    (n - 1) HS < H <= n HS (no slice empty), HS a multiple of the mma
    depth 8 and of a 16-byte copy's 4 floats, 256 while n <= 8; a ring of
    at least 3 stages in at most 232,448 bytes, which also hold the
    forward's ring of at least 3 (x, w) chunk pairs beside its four 64 x
    64 buffers; the same plan again.  Any H has a plan: a slice wider
    than a block's registers hold is done in passes."""
    from paddle_tpu_torch.kernels.linear_xent import lxent_plan

    p = lxent_plan(R, H, V)
    assert 1 <= p.n <= 8
    assert (p.n - 1) * p.hs < H <= p.n * p.hs
    assert p.hs % 8 == 0 and p.hs % 4 == 0 and p.hs % 32 == 0
    assert p.hs == 256 or (p.n == 8 and H > 2048)
    assert p.stages >= 3
    assert p.smem <= 232448
    assert (p.smem // 4 - 4 * 64 * 64) // (2 * 64 * 64) >= 3
    assert lxent_plan(R, H, V) == p


def _tf32_rna(a):
    """float32 -> TF32 (10 explicit mantissa bits) rounded to nearest,
    ties away from zero, as cvt.rna.tf32.f32: add half of the 13 dropped
    bits' unit to the magnitude's bit pattern, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("K", [768, 2048, 3072, 5632])
def test_3xtf32_split_holds_float32_accuracy(K):
    """Why the kernels split each operand: one TF32 product (operands
    rounded to TF32, products exact, float32 sums) is off by >= 1e-4 of
    the largest logit against float64, which fails the card's 1e-4 and
    the port's 1e-5 parity; big*big + big*small + small*big, with
    big = tf32(a) and small = tf32(a - big), holds 1e-5.  So does the
    kernels' chunked accumulation at the FFN depths (K 3072, 5632):
    each 16-deep chunk's three products summed alone, the chunks added
    in float32 in ascending k."""
    rng = np.random.RandomState(40 + K)
    x = rng.randn(64, K).astype("float32")
    w = (rng.randn(K, 64) * K ** -0.5).astype("float32")
    ref = x.astype("float64") @ w.astype("float64")
    xt, wt = _t(x), _t(w)
    xb, wb = _tf32_rna(xt), _tf32_rna(wt)
    xs, ws = _tf32_rna(xt - xb), _tf32_rna(wt - wb)
    assert torch.equal(xb + (xt - xb), xt)  # the split is exact before rounding
    one = (xb @ wb).double().numpy()
    three = (xs @ wb + xb @ ws + xb @ wb).double().numpy()
    scale = np.abs(ref).max()
    assert np.abs(one - ref).max() / scale >= 1e-4
    assert np.abs(three - ref).max() / scale <= 1e-5
    chunked = torch.zeros(64, 64)
    for k in range(0, K, 16):
        c = slice(k, k + 16)
        chunked += (xs[:, c] @ wb[c] + xb[:, c] @ ws[c]) + xb[:, c] @ wb[c]
    assert np.abs(chunked.double().numpy() - ref).max() / scale <= 1e-5


def test_linear_xent_launches_pass_the_plan(monkeypatch):
    """Each linear cross-entropy entry point (B4's forward, dx, dw; B12's
    parts, dx, dw) is handed lxent_plan's four ints, in the order
    build.SIGNATURES declares: after the shape ints, before eps (or the
    stream, for parts)."""
    import importlib

    from paddle_tpu_torch.kernels.linear_xent import fwd_splits, lxent_plan

    slx = importlib.import_module(
        "paddle_tpu_torch.kernels.sharded_linear_xent")
    R, H, V, VT = 20, 776, 33, 99
    rng = np.random.RandomState(41)
    x = _t(rng.randn(R, H).astype("float32"))
    w = _t(rng.randn(H, V).astype("float32"))
    lbl = _t(rng.randint(0, V, (R,)).astype("int64"))
    row = torch.ones(R, 1)
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: calls.append((name, a)))
    linear_xent_fwd(x, w, lbl, 0.1)
    linear_xent_dx(x, w, lbl, row, row, 0.1)
    linear_xent_dw(x, w, lbl, row, row, 0.1)
    slx.linear_xent_parts(x, w, lbl)
    slx.linear_xent_dx_sharded(x, w, lbl, row.reshape(-1), row, row, 0.1, VT)
    slx.linear_xent_dw_sharded(x, w, lbl, row.reshape(-1), row, row, 0.1, VT)
    plan = tuple(lxent_plan(R, H, V))
    assert plan[:2] == (256, 4)
    shape_ints = {"ptt_linear_xent_fwd": (R, H, V, fwd_splits(R, V)),
                  "ptt_linear_xent_dx": (R, H, V),
                  "ptt_linear_xent_dw": (R, H, V),
                  "ptt_linear_xent_parts": (R, H, V, fwd_splits(R, V)),
                  "ptt_linear_xent_dx_sharded": (R, H, V, VT),
                  "ptt_linear_xent_dw_sharded": (R, H, V, VT)}
    assert [name for name, _ in calls] == list(shape_ints)
    for name, args in calls:
        sig = build.SIGNATURES[name]
        assert len(args) + 1 == len(sig), name  # launch appends the stream
        ints = [i for i, kind in enumerate(sig[:-1]) if kind is build._I]
        assert tuple(args[i] for i in ints) == shape_ints[name] + plan, name
        assert ints[-1] == len(args) - 1 - (sig[-2] is build._F), name


# ---------------------------------------------------------------------------
# the dense backward of the PR 1 kernels, through torch.func.vjp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["", "relu", "gelu", "tanh", "sigmoid",
                                 "swish"])
def test_matmul_bias_act_vjp_matches_reference(act):
    rng = np.random.RandomState(28)
    x = rng.randn(12, 20).astype("float32")
    w = (rng.randn(20, 24) * 0.3).astype("float32")
    b = rng.randn(24).astype("float32")
    dy = rng.randn(12, 24).astype("float32")
    _, vjp = jax.vjp(lambda a, c, d: pk.matmul_bias_act(a, c, d, act, 4, 24),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = vjp(jnp.asarray(dy))
    _, vjp_t = torch.func.vjp(
        lambda a, c, d: matmul_bias_act(a, c, d, act), _t(x), _t(w), _t(b))
    for got, want in zip(vjp_t(_t(dy)), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_add_layer_norm_vjp_matches_reference():
    """Cotangents on both outputs (the sum and the normalized rows); the
    row statistics take none, as in the reference."""
    rng = np.random.RandomState(29)
    x, y = (rng.randn(10, 32).astype("float32") for _ in range(2))
    g = (rng.rand(32) + 0.5).astype("float32")
    b = rng.randn(32).astype("float32")
    ds, dout = (rng.randn(10, 32).astype("float32") for _ in range(2))
    _, vjp = jax.vjp(lambda *a: pk.fused_add_layer_norm(*a, 1e-5, 2),
                     *(jnp.asarray(a) for a in (x, y, g, b)))
    ref = vjp((jnp.asarray(ds), jnp.asarray(dout)))
    _, vjp_t = torch.func.vjp(
        lambda *a: fused_add_layer_norm(*a, 1e-5)[:2],
        *(_t(a) for a in (x, y, g, b)))
    for got, want in zip(vjp_t((_t(ds), _t(dout))), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# fused_layer_norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows", [24, 7])
def test_layer_norm_plain_and_vjp_match_reference(rows):
    """The plain version's output and statistics, and the autograd
    wrapper's vjp, against the reference's fused_layer_norm (Pallas
    interpret mode) under jax.vjp.  rtol = atol = 1e-5."""
    rng = np.random.RandomState(31)
    x = (rng.randn(rows, 48) * 2 + 0.5).astype("float32")
    g = (rng.rand(48) + 0.5).astype("float32")
    b = rng.randn(48).astype("float32")
    dy = rng.randn(rows, 48).astype("float32")
    ref, vjp = jax.vjp(lambda *a: pk.fused_layer_norm(*a, 1e-5),
                       *(jnp.asarray(a) for a in (x, g, b)))
    ref_grads = vjp(jnp.asarray(dy))
    y, mean, var = layer_norm_plain(_t(x), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)
    assert mean.shape == var.shape == (rows,)
    np.testing.assert_allclose(mean.numpy(), x.mean(-1), **TOL)
    np.testing.assert_allclose(var.numpy(), x.var(-1), **TOL)
    out, vjp_t = torch.func.vjp(lambda *a: fused_layer_norm(*a, 1e-5)[0],
                                _t(x), _t(g), _t(b))
    np.testing.assert_array_equal(out.numpy(), y.numpy())
    for got, want in zip(vjp_t(_t(dy)), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("R", [1, 8, 264, 8192])
def test_ln_plan_takes_every_width(R):
    """ln_plan takes every H up to the block form's 48 KB row (12288
    floats) and raises past it; the register form exactly where the row
    fits it (H <= WARP_MAX_H), with the fewest float4 slots a lane that
    hold the row, float4 access where H % 4 == 0 and 1 to 8 rows a block
    (every SM a block where the rows allow)."""
    for H in range(1, ln_mod.BLOCK_MAX_H + 1):
        plan = ln_mod.ln_plan(R, H)
        if H > ln_mod.WARP_MAX_H:
            assert plan == (ln_mod.BLOCK, 0, 0, 0), H
            continue
        assert plan.form == ln_mod.WARP and 128 * plan.n4 >= H, H
        smaller = [n for n in ln_mod.N4_SLOTS if n < plan.n4]
        assert all(128 * n < H for n in smaller), H
        assert plan.vec == (H % 4 == 0), H
        assert plan.rows == max(1, min(8, R // ln_mod.SMS)), H
    with pytest.raises(ValueError, match="48 KB"):
        ln_mod.ln_plan(R, ln_mod.BLOCK_MAX_H + 1)


def test_layer_norm_launch_passes_the_plan(monkeypatch):
    """fused_layer_norm hands build.launch (R, H) and ln_plan's four ints
    in the order build.SIGNATURES declares; a view that does not start on
    16 bytes takes the register form by floats (vec 0)."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: calls.append((name, a)))
    sig = build.SIGNATURES["ptt_layer_norm"]
    ints = [i for i, kind in enumerate(sig[:-1]) if kind is build._I]
    for R, H in ((8192, 768), (3, 770), (2, 2048), (5, 1000)):
        fused_layer_norm(torch.ones(R, H), torch.ones(H), torch.zeros(H))
        name, args = calls[-1]
        assert name == "ptt_layer_norm" and len(args) + 1 == len(sig)
        assert tuple(args[i] for i in ints) == (R, H) + tuple(
            ln_mod.ln_plan(R, H))
    x = torch.ones(5 * 768 + 1)[1:].view(5, 768)
    fused_layer_norm(x, torch.ones(768), torch.zeros(768))
    assert tuple(calls[-1][1][i] for i in ints)[2:] == (ln_mod.WARP, 6, 0, 1)


@pytest.mark.parametrize("H", [1024, 1025, 2048])
def test_add_layer_norm_matches_reference_at_the_form_edges(H):
    """The plain version and the autograd wrapper against the reference's
    fused_add_layer_norm (Pallas interpret mode) at add_ln_plan's edges:
    H 1024 (one warp of 8 float4 slots a lane), 1025 (two warps, scalar
    access) and 2048 (the TinyLlama widths).  rtol = atol = 1e-5."""
    rng = np.random.RandomState(H)
    x, y = (rng.randn(9, H).astype("float32") for _ in range(2))
    g = (rng.rand(H) + 0.5).astype("float32")
    b = rng.randn(H).astype("float32")
    rs, ro = pk.fused_add_layer_norm(*(jnp.asarray(a) for a in (x, y, g, b)),
                                     1e-5, 1)
    s, o, mean, var = fused_add_layer_norm(_t(x), _t(y), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rs).mean(-1), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(rs).var(-1), **TOL)


@pytest.mark.parametrize("R", [1, 8, 264, 8192])
def test_add_ln_plan_takes_every_width(R):
    """add_ln_plan takes every H from 1 to MAX_H (16384, past the 12288
    the block form claimed and failed at from 12256) and raises exactly
    past it: the fewest warps a row of 1, 2, 4, 8 that hold the row at
    WARP_SLOTS float4 slots a lane (8 warps beyond), the fewest
    instantiated slots that cover H, float4 access where H % 4 == 0, 1 to
    8 rows a block with rows x warps <= 8 (the kernel's static exchange
    of a float a warp, no dynamic shared memory) and every SM a block
    where the rows allow; warps and slots, which fix a row's sums, the
    same at every R."""
    for H in range(1, aln_mod.MAX_H + 1):
        plan = aln_mod.add_ln_plan(R, H)
        need = -(-H // 128)
        assert plan.warps in (1, 2, 4, 8), H
        assert need <= aln_mod.WARP_SLOTS * plan.warps or plan.warps == 8, H
        assert plan.warps == 1 or need > aln_mod.WARP_SLOTS * plan.warps // 2
        assert plan.n4 in aln_mod.N4_SLOTS and 128 * plan.n4 * plan.warps >= H
        assert all(128 * n * plan.warps < H
                   for n in aln_mod.N4_SLOTS if n < plan.n4), H
        assert plan.vec == (H % 4 == 0), H
        assert 1 <= plan.rows and plan.rows * plan.warps <= aln_mod.MAX_WARPS
        assert plan.rows == max(1, min(8 // plan.warps, R // aln_mod.SMS))
        assert plan[:3] == aln_mod.add_ln_plan(1, H)[:3], H
    for H in (0, aln_mod.MAX_H + 1):
        with pytest.raises(ValueError, match=r"\[%d, %d\]" % (R, H)):
            aln_mod.add_ln_plan(R, H)


def test_add_layer_norm_launch_passes_the_plan(monkeypatch):
    """fused_add_layer_norm hands build.launch (R, H) and add_ln_plan's
    four ints in the order build.SIGNATURES declares; a view of x or y
    that does not start on 16 bytes takes the scalar form (vec 0), and a
    row past MAX_H raises before any launch."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: calls.append((name, a)))
    sig = build.SIGNATURES["ptt_add_layer_norm"]
    ints = [i for i, kind in enumerate(sig[:-1]) if kind is build._I]
    for R, H in ((8192, 768), (3, 770), (2, 2048), (5, 1025), (4, 12288)):
        fused_add_layer_norm(torch.ones(R, H), torch.ones(R, H),
                             torch.ones(H), torch.zeros(H))
        name, args = calls[-1]
        assert name == "ptt_add_layer_norm" and len(args) + 1 == len(sig)
        assert tuple(args[i] for i in ints) == (R, H) + tuple(
            aln_mod.add_ln_plan(R, H))
    off = torch.ones(5 * 768 + 1)[1:].view(5, 768)
    for x, y in ((off, torch.ones(5, 768)), (torch.ones(5, 768), off)):
        fused_add_layer_norm(x, y, torch.ones(768), torch.zeros(768))
        assert tuple(calls[-1][1][i] for i in ints)[2:] == (6, 0, 1, 1)
    n = len(calls)
    H = aln_mod.MAX_H + 4
    with pytest.raises(ValueError, match="fused_add_layer_norm"):
        fused_add_layer_norm(torch.ones(2, H), torch.ones(2, H),
                             torch.ones(H), torch.zeros(H))
    assert len(calls) == n


# ---------------------------------------------------------------------------
# flash_attention: forward, dq and dk/dv against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,with_bias,tq,tk", [
    (True, False, 256, 256),   # two 128-blocks a side: the causal block skip
    (True, True, 256, 256),
    (False, True, 256, 256),
    (False, False, 12, 20),    # Tq != Tk, one block a side
    (True, True, 12, 12),
])
def test_flash_attention_matches_reference_kernel(causal, with_bias, tq, tk):
    """flash_attention_plain's (o, lse) against the reference's _flash_fwd,
    and the autograd wrapper's (dq, dk, dv, dkbias) under torch.func.vjp
    and flash_attention_grad_plain's against the reference's
    flash_attention under jax.vjp, all in Pallas interpret mode (blocks
    of 128 or the whole length).  rtol = atol = 1e-5."""
    rng = np.random.RandomState(32)
    bh, d, scale = 3, 16, 0.3
    q = rng.randn(bh, tq, d).astype("float32")
    k = rng.randn(bh, tk, d).astype("float32")
    v = rng.randn(bh, tk, d).astype("float32")
    do = rng.randn(bh, tq, d).astype("float32")
    kb = None
    if with_bias:
        kb = rng.randn(bh, tk).astype("float32")
        kb[:, -2:] = -1e9  # masked keys: zero probability and gradient
    bq, bk = min(tq, 128), min(tk, 128)
    jkb = None if kb is None else jnp.asarray(kb)
    r_o, r_lse = pk._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jkb if kb is not None else jnp.zeros((bh, tk), jnp.float32),
        causal, scale, bq, bk)
    prim = [jnp.asarray(a) for a in (q, k, v)] + ([jkb] if kb is not None
                                                  else [])
    r_out, vjp = jax.vjp(
        lambda *a: pk.flash_attention(*a[:3], a[3] if len(a) > 3 else None,
                                      causal, scale, bq, bk), *prim)
    r_grads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(np.asarray(r_out), np.asarray(r_o), **TOL)

    tkb = None if kb is None else _t(kb)
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), tkb, causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(r_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), **TOL)

    tprim = [_t(a) for a in (q, k, v)] + ([tkb] if kb is not None else [])
    out, vjp_t = torch.func.vjp(
        lambda *a: flash_attention(*a[:3], a[3] if len(a) > 3 else None,
                                   causal, scale), *tprim)
    grads = vjp_t(_t(do))
    np.testing.assert_array_equal(out.numpy(), o.numpy())
    assert len(grads) == len(r_grads)
    for got, want in zip(grads, r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    delta = (_t(do) * o).sum(-1)
    plain = flash_attention_grad_plain(_t(q), _t(k), _t(v), tkb, lse, _t(do),
                                       delta, causal, scale)
    for got, want in zip(plain, r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if kb is not None:
        assert np.abs(plain[3].numpy()[:, -2:]).max() == 0.0


def test_flash_attention_grad_guards_rows_without_a_key():
    """A row whose lse is the NEG_INF sentinel takes no gradient (the
    reference's lse <= NEG_INF / 2 guard)."""
    rng = np.random.RandomState(33)
    q, k, v, do = (_t(rng.randn(1, 4, 8).astype("float32")) for _ in range(4))
    lse = torch.zeros(1, 4)
    lse[0, 2] = -1e30
    delta = torch.zeros(1, 4)
    dq, dk, dv, dkb = flash_attention_grad_plain(q, k, v, None, lse, do,
                                                 delta, True, 0.5)
    assert float(dq[0, 2].abs().max()) == 0.0
    dq2, _, _, _ = flash_attention_grad_plain(q, k, v, None, torch.zeros(1, 4),
                                              do, delta, True, 0.5)
    assert float(dq2[0, 2].abs().max()) > 0.0


def test_flash_attention_kernel_path_checks_shapes(monkeypatch):
    """On the kernel path the wrapper refuses what the kernels cannot
    take: causal with Tq != Tk, a head dim other than 64 and 128, a key
    bias of the wrong shape."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch", lambda *a: None)
    q = torch.ones(2, 4, 64)
    k = torch.ones(2, 6, 64)
    with pytest.raises(ValueError, match="causal requires"):
        flash_attention_fwd(q, k, k, None, True)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(torch.ones(2, 4, 32), torch.ones(2, 4, 32),
                            torch.ones(2, 4, 32))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_fwd(q, k, k, torch.zeros(2, 4))
    o, lse = flash_attention_fwd(q, k, k, torch.zeros(2, 6))
    assert o.shape == (2, 4, 64) and lse.shape == (2, 4)


# ---------------------------------------------------------------------------
# B3d: the few-row form of flash attention's forward (the decode steps)
# ---------------------------------------------------------------------------
def _decode_bias(rng, bh, tk):
    """decode_pos_mask's key bias (0 up to a row's position, NEG_INF
    beyond), each row at its own position, the first row with every key
    masked."""
    pos = rng.randint(0, tk, bh)
    kb = np.where(np.arange(tk)[None, :] <= pos[:, None], 0.0,
                  -1e30).astype("float32")
    kb[0] = -1e30
    return kb


@pytest.mark.parametrize("tq", [1, 8])
def test_flash_attention_plain_matches_reference_at_decode_forms(tq):
    """flash_attention_plain's (o, lse) at the decode steps' forms (Tq 1,
    the one-token step; Tq 8, the GQA fold) over Tk 256 with a
    decode_pos_mask key bias, one row whose every key is masked and one
    whose every key sits at -1e9 (o is the mean of v in both), against
    the reference's _flash_fwd in Pallas interpret mode (key blocks of
    128).  rtol = atol = 1e-5."""
    rng = np.random.RandomState(35)
    bh, tk, d, scale = 4, 256, 16, 0.25
    q = rng.randn(bh, tq, d).astype("float32")
    k = rng.randn(bh, tk, d).astype("float32")
    v = rng.randn(bh, tk, d).astype("float32")
    kb = _decode_bias(rng, bh, tk)
    kb[1] = -1e9
    r_o, r_lse = pk._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(kb), False, scale,
                               tq, 128)
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), _t(kb), False, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(r_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), **TOL)
    for row in (0, 1):
        np.testing.assert_allclose(o.numpy()[row], np.broadcast_to(
            v[row].mean(0), (tq, d)), **TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tk", [1, 7, 32, 33, 129, 300, 1000, 1024, 2048,
                                2050, 4000])
def test_rows_plan_cuts_tk_into_fixed_slices(tk, d):
    """rows_plan covers Tk exactly once: slices of a multiple of 32 keys,
    at most 256 (128 at d 128: the kernel's shared memory), the last
    one ragged or whole, one slice where Tk is shorter than a slice; the
    decode steps' Tk 1024 and 2048 in 8 slices."""
    plan = fa_mod.rows_plan(tk, d)
    assert plan.slice_len % 32 == 0
    assert 32 <= plan.slice_len <= (256 if d == 64 else 128)
    assert ((plan.slices - 1) * plan.slice_len < tk
            <= plan.slices * plan.slice_len)
    if tk <= 128:
        assert plan.slices == 1 and plan.slice_len == 32 * -(-tk // 32)
    if d == 64 and tk in (1024, 2048):
        assert plan == (tk // 8, 8)


def _rows_emulation(q, k, v, kb, scale, plan):
    """The few-row kernel's arithmetic in plain PyTorch: q scaled first,
    a 32-key chunk a warp with its own (m, l, acc), the warps merged in
    order into their slice, the slices merged in order by log-sum-exp."""
    s = torch.einsum("bqd,bkd->bqk", q * scale, k)
    if kb is not None:
        s = s + kb[:, None, :]

    def merge(parts):
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_all = torch.zeros_like(m_all)
        acc = torch.zeros(q.shape)
        for m, l, a in parts:
            w = torch.exp(m - m_all)
            l_all = l_all + l * w
            acc = acc + a * w[..., None]
        return m_all, l_all, acc

    tk = k.shape[1]
    slices = []
    for s0 in range(0, tk, plan.slice_len):
        s1 = min(tk, s0 + plan.slice_len)
        chunks = []
        for c0 in range(s0, s1, 32):
            c1 = min(s1, c0 + 32)
            m = s[:, :, c0:c1].amax(-1)
            p = torch.exp(s[:, :, c0:c1] - m[..., None])
            chunks.append((m, p.sum(-1),
                           torch.einsum("bqk,bkd->bqd", p, v[:, c0:c1])))
        slices.append(merge(chunks))
    m, l, acc = merge(slices)
    return acc / l[..., None], m + torch.log(l)


@pytest.mark.parametrize("tq,tk", [(1, 1024), (8, 2048), (3, 300), (2, 40)])
def test_rows_slice_and_merge_math_matches_plain(tq, tk):
    """The emulated slice-and-merge arithmetic of the few-row kernel, at
    rows_plan's split, equals flash_attention_plain within 1e-6: a row
    with every key masked (the mean of v), a row whose first slice is
    wholly masked while later keys are live, keys at -1e9, and no
    bias."""
    rng = np.random.RandomState(36)
    bh, d, scale = 4, 64, 0.125
    q, k, v = (_t(rng.randn(bh, n, d).astype("float32"))
               for n in (tq, tk, tk))
    kb = _decode_bias(rng, bh, tk)
    kb[1] = 0.0
    kb[1, :min(tk - 1, 128)] = -1e30  # a slice wholly masked, keys after
    kb[2, -3:] = -1e9
    plan = fa_mod.rows_plan(tk, d)
    for bias in (_t(kb), None):
        o, lse = _rows_emulation(q, k, v, bias, scale, plan)
        p_o, p_lse = flash_attention_plain(q, k, v, bias, False, scale)
        np.testing.assert_allclose(o.numpy(), p_o.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(lse.numpy(), p_lse.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_rows_form_is_chosen_exactly_for_the_decode_forms(monkeypatch):
    """flash_attention_fwd hands the decode steps' calls (Tq <= 8, not
    causal, no window, no segment ids; with or without a key bias) to
    the few-row kernel and every other form to the tile kernel; each
    launch counts on its own kernel's counter only, the tile kernel's on
    the entry point's."""
    assert fa_mod.rows_form(1) and fa_mod.rows_form(8)
    assert not fa_mod.rows_form(9) and not fa_mod.rows_form(0)
    assert not fa_mod.rows_form(1, causal=True)
    assert not fa_mod.rows_form(1, True, window=4)
    assert not fa_mod.rows_form(1, seg=torch.zeros(1, 1))
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch", lambda name, *a: calls.append(name))
    k = torch.ones(2, 40, 64)
    kb = torch.zeros(2, 40)
    seg = torch.zeros(2, 8, dtype=torch.int32)
    fwd, rows = flash_attention_fwd.launches, flash_attention_fwd_rows.launches
    for q, bias, causal, window, sg, want in (
            (torch.ones(2, 1, 64), kb, False, 0, None, "rows"),
            (torch.ones(2, 8, 64), None, False, 0, None, "rows"),
            (torch.ones(2, 9, 64), kb, False, 0, None, "fwd"),
            (torch.ones(2, 40, 64), None, True, 0, None, "fwd"),
            (torch.ones(2, 40, 64), None, True, 16, None, "fwd")):
        flash_attention_fwd(q, k, k, bias, causal, None, window, sg)
        assert calls[-1] == "ptt_flash_attention_" + want
    q8, k8 = torch.ones(2, 8, 64), torch.ones(2, 8, 64)
    flash_attention_fwd(q8, k8, k8, None, False, None, 0, seg)
    assert calls[-1] == "ptt_flash_attention_fwd"
    flash_attention_piece_fwd(torch.ones(2, 1, 64), k, k, True, None,
                              torch.zeros(1, dtype=torch.long))
    assert calls[-1] == "ptt_flash_attention_fwd"
    assert flash_attention_fwd.launches - fwd == 4
    assert flash_attention_fwd_rows.launches - rows == 2
    with pytest.raises(ValueError, match="Tq 9"):
        flash_attention_fwd_rows(torch.ones(2, 9, 64), k, k)
    off = torch.ones(2 * 40 * 64 + 1)[1:].view(2, 40, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd_rows(torch.ones(2, 1, 64), off, k)


def test_rows_launch_passes_the_plan(monkeypatch):
    """The few-row wrapper hands build.launch the shape ints (BH, Tq, Tk,
    d) and rows_plan's two, in the order build.SIGNATURES declares, and
    the [BH, Tq, slices, d] and [BH, Tq, slices, 2] workspaces where
    there is more than one slice; the plan is the same at any BH and
    any bias."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: calls.append((name, a)))
    sig = build.SIGNATURES["ptt_flash_attention_rows"]
    ints = [i for i, kind in enumerate(sig[:-1]) if kind is build._I]
    for bh, tq, tk, d in ((1, 1, 1024, 64), (48, 1, 1024, 64),
                          (8, 8, 2048, 64), (3, 3, 40, 128)):
        kb = torch.full((bh, tk), -1e30)
        flash_attention_fwd_rows(torch.ones(bh, tq, d), torch.ones(bh, tk, d),
                                 torch.ones(bh, tk, d), kb)
        name, args = calls[-1]
        plan = fa_mod.rows_plan(tk, d)
        assert name == "ptt_flash_attention_rows"
        assert len(args) + 1 == len(sig)  # launch appends the stream
        assert tuple(args[i] for i in ints) == (bh, tq, tk, d) + tuple(plan)
        part_o, part_ml = args[6], args[7]
        if plan.slices > 1:
            assert part_o.shape == (bh, tq, plan.slices, d)
            assert part_ml.shape == (bh, tq, plan.slices, 2)
        else:
            assert part_o is None and part_ml is None
    # BH 1 and BH 48 at one Tk: the same split
    assert calls[0][1][12:14] == calls[1][1][12:14] == (128, 8)


# ---------------------------------------------------------------------------
# B3's tile kernels: the plan (the form), and dk/dv at the tiles' edges
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_flash_plan_depends_on_the_shape_only(kernel):
    """flash_plan is a function of (kernel, Tq, Tk, d) alone: head dim 64
    takes the tensor-core form except dq at a shape within 64 x 64 (the
    SIMT form), head dim 128 the SIMT form."""
    tc, simt = fa_mod.FLASH_TC, fa_mod.FLASH_SIMT
    for tq, tk in ((1024, 1024), (2048, 2048), (128, 128), (64, 64),
                   (16, 1024), (1024, 16), (65, 64), (17, 17)):
        form = fa_mod.flash_plan(kernel, tq, tk, 64)
        assert form == fa_mod.flash_plan(kernel, tq, tk, 64)
        if kernel == "dq" and tq <= 64 and tk <= 64:
            assert form == simt
        else:
            assert form == tc
        assert fa_mod.flash_plan(kernel, tq, tk, 128) == simt


@pytest.mark.parametrize("tq,tk,block_q,block_k,causal,window,with_bias", [
    (17, 17, 17, 17, True, 0, False),     # under one warp's 16 rows past one
    (17, 17, 17, 17, False, 0, True),
    (64, 64, 32, 32, True, 0, False),     # one 128-row block, half its warps
    (33, 33, 33, 33, True, 1, False),     # each query sees itself only
    (200, 200, 40, 40, True, 24, False),  # window 24: no multiple of 8 or 16
    (300, 300, 100, 100, True, 24, True),
    (96, 96, 32, 32, True, 40, False),
    (130, 70, 65, 70, False, 0, True),    # ragged Tq != Tk, key bias
    (48, 48, 48, 48, True, 0, True),
    (40, 136, 40, 68, False, 0, False),
])
def test_dkv_matches_the_reference_at_the_tile_edges(
        tq, tk, block_q, block_k, causal, window, with_bias):
    """flash_attention_dkv's (dk, dv, dkbias) against the reference's
    _flash_bwd (Pallas interpret mode) at the edges of the tensor-core
    form's tiles (16-row warps, 128-row blocks, 32-query dk/dv tiles):
    lengths under and past one warp's rows, windows of 1, 24 and 40, and
    ragged non-causal shapes.  On the CPU the wrapper takes its plain
    version, the one chip_smoke.py holds the kernel against at these
    edges.  rtol = atol = 1e-5."""
    rng = np.random.RandomState(tq + tk + window)
    bh, d, scale = 2, 16, 0.25
    q, do = (rng.randn(bh, tq, d).astype("float32") for _ in range(2))
    k, v = (rng.randn(bh, tk, d).astype("float32") for _ in range(2))
    kb = rng.randn(bh, tk).astype("float32")
    if with_bias:
        kb[:, -3:] = -1e9  # masked keys: zero probability and gradient
    else:
        kb[:] = 0.0
    jq, jk, jv, jkb = (jnp.asarray(a) for a in (q, k, v, kb))
    r_o, r_lse = pk._flash_fwd(jq, jk, jv, jkb, causal, scale, block_q,
                               block_k, window)
    _, r_dk, r_dv, r_dkb = pk._flash_bwd(
        jq, jk, jv, jkb, r_o, r_lse, jnp.asarray(do), causal, scale,
        block_q, block_k, window=window)
    o, lse = _t(np.array(r_o)), _t(np.array(r_lse))
    delta = (_t(do) * o).sum(-1)
    dk, dv, dkb = flash_attention_dkv(
        _t(q), _t(k), _t(v), _t(kb) if with_bias else None, lse, _t(do),
        delta, causal, scale, window)
    np.testing.assert_allclose(dk.numpy(), np.asarray(r_dk), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(r_dv), **TOL)
    if with_bias:
        np.testing.assert_allclose(dkb.numpy(), np.asarray(r_dkb), **TOL)
        assert np.abs(dkb.numpy()[:, -3:]).max() == 0.0
    else:
        assert dkb is None


def test_flash_launches_pass_the_plan(monkeypatch):
    """_fwd, _dq and _dkv (B3, B9's piece, B8's backward) hand
    build.launch flash_plan's form right after the head dim, in the
    order build.SIGNATURES declares, the form of the kernel and the
    shape whatever the batch; a q, k or v that does not start on 16
    bytes raises."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: calls.append((name, a)))

    def form_arg(name, args):
        sig = build.SIGNATURES[name]
        assert len(args) + 1 == len(sig)  # launch appends the stream
        ints = [i for i, kind in enumerate(sig[:-1]) if kind is build._I]
        # BH, Tq, Tk, d, the form, causal, qstride
        return [args[i] for i in ints[:7]]

    for bh, tq, tk, causal, window in ((2, 40, 40, True, 0),
                                       (3, 300, 300, True, 24),
                                       (1, 64, 64, False, 0),
                                       (2, 130, 70, False, 0)):
        q, k = torch.ones(bh, tq, 64), torch.ones(bh, tk, 64)
        lse, do = torch.zeros(bh, tq), torch.ones(bh, tq, 64)
        flash_attention_fwd(q, k, k, None, causal, None, window)
        flash_attention_dq(q, k, k, None, lse, do, lse, causal, None, window)
        flash_attention_dkv(q, k, k, None, lse, do, lse, causal, None, window)
        for (name, args), kernel in zip(calls[-3:], ("fwd", "dq", "dkv")):
            assert name == "ptt_flash_attention_" + kernel
            assert form_arg(name, args) == [
                bh, tq, tk, 64, fa_mod.flash_plan(kernel, tq, tk, 64),
                int(causal), 0]
    qoff, q, k = torch.tensor([5]), torch.ones(2, 8, 64), torch.ones(2, 40, 64)
    lse = torch.zeros(2, 8)
    flash_attention_piece_fwd(q, k, k, True, None, qoff)
    flash_attention_piece_dkv(q, k, k, lse, q, lse, True, None, qoff)
    flash_attention_qvec_dq(q, k, k, lse, q, lse, torch.tensor([0, 39]))
    for (name, args), kernel, stride in zip(calls[-3:], ("fwd", "dkv", "dq"),
                                            (0, 0, 1)):
        assert form_arg(name, args) == [
            2, 8, 40, 64, fa_mod.flash_plan(kernel, 8, 40, 64), 1, stride]
    off = torch.ones(2 * 40 * 64 + 1)[1:].view(2, 40, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(off, off, off, None, True)


# ---------------------------------------------------------------------------
# flash_attention_piece and the qvec backward: the based kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("qoff", [0, 128])
def test_flash_attention_piece_matches_reference_kernel(qoff):
    """flash_attention_piece_plain's (o, lse) against the reference's
    flash_attention_piece (Pallas interpret mode, blocks 128), and the
    autograd wrapper's (dq, dk, dv) under torch.func.vjp and
    flash_attention_piece_grad_plain's against its jax.vjp, with nonzero
    cotangents on both o and lse: BH 2, Tq 128 at global offset qoff
    over Tk 256 (qoff 128: the chunk's last query sees every key).
    rtol = atol = 1e-5."""
    rng = np.random.RandomState(36)
    bh, tq, tk, d, scale = 2, 128, 256, 64, 0.125
    q = rng.randn(bh, tq, d).astype("float32")
    k = rng.randn(bh, tk, d).astype("float32")
    v = rng.randn(bh, tk, d).astype("float32")
    do = rng.randn(bh, tq, d).astype("float32")
    dlse = rng.randn(bh, tq).astype("float32")
    jqoff = jnp.asarray(np.array([qoff], "int32"))
    (r_o, r_lse), vjp = jax.vjp(
        lambda a, b, c: pk.flash_attention_piece(a, b, c, True, scale, 128,
                                                 128, 0, jqoff),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    r_grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    tqoff = torch.tensor([qoff])
    o, lse = flash_attention_piece_plain(_t(q), _t(k), _t(v), True, scale,
                                         tqoff)
    np.testing.assert_allclose(o.numpy(), np.asarray(r_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), **TOL)
    out, vjp_t = torch.func.vjp(
        lambda a, b, c: flash_attention_piece(a, b, c, True, scale, tqoff),
        _t(q), _t(k), _t(v))
    np.testing.assert_array_equal(out[0].numpy(), o.numpy())
    np.testing.assert_array_equal(out[1].numpy(), lse.numpy())
    grads = vjp_t((_t(do), _t(dlse)))
    plain = flash_attention_piece_grad_plain(_t(q), _t(k), _t(v), o, lse,
                                             _t(do), _t(dlse), True, scale,
                                             tqoff)
    for got, pl, want in zip(grads, plain, r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(pl.numpy(), np.asarray(want), **TOL)
    # the lse cotangent reaches the gradient
    no_dlse = flash_attention_piece_grad_plain(
        _t(q), _t(k), _t(v), o, lse, _t(do), torch.zeros(bh, tq), True,
        scale, tqoff)
    assert float((no_dlse[0] - plain[0]).abs().max()) > 1e-3


def test_flash_attention_qvec_backward_matches_reference_kernel():
    """flash_attention_qvec's vjp (its autograd function: the forward with
    the lse, the based dq and dk/dv) against the reference's
    flash_attention_qvec under jax.vjp (Pallas interpret mode) at per-row
    bases 0, mid-cache and Tk - Tq.  rtol = atol = 1e-5."""
    rng = np.random.RandomState(37)
    bh, tq, tk, d = 4, 16, 64, 16
    q = rng.randn(bh, tq, d).astype("float32")
    k = rng.randn(bh, tk, d).astype("float32")
    v = rng.randn(bh, tk, d).astype("float32")
    do = rng.randn(bh, tq, d).astype("float32")
    qs = np.array([0, 20, 48, 5], "int32")
    r_out, vjp = jax.vjp(
        lambda a, b, c: pk.flash_attention_qvec(a, b, c, jnp.asarray(qs),
                                                None, tq, 32),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    r_grads = vjp(jnp.asarray(do))
    out, vjp_t = torch.func.vjp(
        lambda a, b, c: flash_attention_qvec(a, b, c,
                                             _t(qs.astype("int64"))),
        _t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **TOL)
    for got, want in zip(vjp_t(_t(do)), r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# flash_attention_qvec's forward kernel (B8a): its plan and its arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tk", [1, 16, 40, 300, 1024, 2048, 4096])
def test_qvec_plan_cuts_tk_into_fixed_slices(tk, d):
    """qvec_plan puts every key in exactly one slice: slices a multiple
    of the kernel's 16-key chunk, none wholly past Tk, at most one warp
    a chunk of the slice, and shared memory within the 232,448 bytes a
    block may have; the serving steps' Tk 1024 and 2048 in 1 and 2
    slices of 1024 keys over 8 warps; a function of Tk and d alone (the
    same plan twice)."""
    plan = fa_mod.qvec_plan(tk, d)
    chunk = fa_mod.QVEC_CHUNK
    assert plan.slice_len % chunk == 0
    assert (plan.slices - 1) * plan.slice_len < tk <= plan.slices * plan.slice_len
    assert plan.slice_len - tk < chunk  # no chunk wholly past Tk
    assert 1 <= plan.warps <= min(8, plan.slice_len // chunk)
    assert plan.smem == fa_mod.qvec_smem(d, plan.warps) <= 232448
    owners = np.zeros(tk, int)
    for s in range(plan.slices):
        owners[s * plan.slice_len:(s + 1) * plan.slice_len] += 1
    assert (owners == 1).all()
    if d == 64 and tk in (1024, 2048):
        assert plan[:3] == (8, 1024, tk // 1024)
    assert fa_mod.qvec_plan(tk, d) == plan


NEG_INF = fa_mod.NEG_INF


def _split3(x):
    """x as tf32 big + small parts (cvt.rna's rounding, as the kernel's
    integer split)."""
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _mm3(a, b):
    """a @ b in 3xTF32: small*big + big*small + big*big of the split
    operands, float32 sums."""
    a_big, a_small = _split3(a)
    b_big, b_small = _split3(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _qvec_emulation(q, k, v, qstart, scale, plan):
    """The qvec forward kernel's arithmetic in plain PyTorch: q * scale
    split once; per (row, 16-query tile, slice) each warp w walks the
    slice's chunks w, w + W, ... that start before the tile's last
    cutoff, S over 64-deep parts of 3xTF32 products added in float32,
    the per-query cutoff, the online softmax, P v in 3xTF32 from zero
    each chunk; the warps merged in order, then the slices in order by
    log-sum-exp.  Returns (o, lse)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    out = torch.zeros(bh, tq, d)
    lse = torch.zeros(bh, tq)
    qsc = q * scale

    def merge(parts):
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_all = torch.zeros_like(m_all)
        acc = torch.zeros(parts[0][2].shape)
        for m, l, a in parts:
            wgt = torch.exp(m - m_all)
            l_all = l_all + l * wgt
            acc = acc + a * wgt[:, None]
        return m_all, l_all, acc

    for b in range(bh):
        for q0 in range(0, tq, 16):
            rows = qsc[b, q0:q0 + 16]
            pos = int(qstart[b]) + q0 + torch.arange(rows.shape[0])
            kend = min(tk, int(pos[-1]) + 1)
            slices = []
            for s in range(plan.slices):
                s_lo = s * plan.slice_len
                s_hi = min(kend, s_lo + plan.slice_len)
                chunks = list(range(s_lo, s_hi, fa_mod.QVEC_CHUNK))
                warps = []
                for w in range(plan.warps):
                    m = torch.full((rows.shape[0],), NEG_INF)
                    l = torch.zeros(rows.shape[0])
                    acc = torch.zeros(rows.shape[0], d)
                    for c0 in chunks[w::plan.warps]:
                        c1 = min(tk, c0 + fa_mod.QVEC_CHUNK)
                        sc = torch.zeros(rows.shape[0], c1 - c0)
                        for p0 in range(0, d, 64):
                            sc = sc + _mm3(rows[:, p0:p0 + 64],
                                           k[b, c0:c1, p0:p0 + 64].T)
                        live = torch.arange(c0, c1)[None, :] <= pos[:, None]
                        sc = torch.where(live, sc, torch.tensor(NEG_INF))
                        m_new = torch.maximum(m, sc.amax(-1))
                        p = torch.where(live, torch.exp(sc - m_new[:, None]),
                                        torch.tensor(0.0))
                        alpha = torch.exp(m - m_new)
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + _mm3(p, v[b, c0:c1])
                        m = m_new
                    warps.append((m, l, acc))
                slices.append(merge(warps))
            m, l, acc = merge(slices)
            safe = torch.where(l == 0, torch.ones_like(l), l)
            out[b, q0:q0 + 16] = acc / safe[:, None]
            lse[b, q0:q0 + 16] = m + torch.log(safe)
    return out, lse



@pytest.mark.parametrize("tk", [300, 1024])
def test_qvec_kernel_arithmetic_matches_reference_kernel(tk):
    """The qvec kernel's arithmetic, emulated at qvec_plan's split,
    against pk.flash_attention_qvec in Pallas interpret mode within 1e-5
    (o, and the lse against flash_attention_plain's): BH 8, Tq 16, query
    bases 0, mid-cache and Tk - Tq, and a free slot (width 0: base 0,
    zero queries) among them."""
    rng = np.random.RandomState(41)
    bh, tq, d, scale = 8, 16, 64, 0.125
    q = rng.randn(bh, tq, d).astype("float32")
    k = rng.randn(bh, tk, d).astype("float32")
    v = rng.randn(bh, tk, d).astype("float32")
    q[4] = 0.0  # the free slot
    qs = np.array([0, tk // 2, tk - tq, 37, 0, tk // 3, tk - tq - 1, 1],
                  "int32")
    ref = pk.flash_attention_qvec(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(qs), scale, tq,
                                  100 if tk == 300 else 128)
    plan = fa_mod.qvec_plan(tk, d)
    o, lse = _qvec_emulation(_t(q), _t(k), _t(v), qs, scale, plan)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
    _, p_lse = flash_attention_plain(_t(q), _t(k), _t(v), None, True, scale,
                                     _t(qs))
    np.testing.assert_allclose(lse.numpy(), p_lse.numpy(), **TOL)


def test_qvec_kernel_arithmetic_at_head_dim_128_and_ragged_tiles():
    """The same emulation at d 128 (two 64-deep score parts) and Tq 20
    (a second, ragged query tile) over Tk 300 in slices of 128 (three,
    the last ragged), against the plain version within 1e-5."""
    rng = np.random.RandomState(42)
    bh, tq, tk, d = 3, 20, 300, 128
    q, k, v = (_t(rng.randn(bh, n, d).astype("float32"))
               for n in (tq, tk, tk))
    qs = np.array([0, 130, tk - tq], "int32")
    plan = fa_mod.qvec_plan(tk, d, slice_len=128)
    assert plan.slices == 3
    o, lse = _qvec_emulation(q, k, v, qs, d ** -0.5, plan)
    p_o, p_lse = flash_attention_plain(q, k, v, None, True, d ** -0.5,
                                       _t(qs))
    np.testing.assert_allclose(o.numpy(), p_o.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), p_lse.numpy(), **TOL)


@pytest.mark.parametrize("bh,tq,tk,d", [(1, 16, 1024, 64), (96, 16, 1024, 64),
                                        (256, 16, 2048, 64), (6, 4, 300, 128),
                                        (2, 16, 40, 64)])
def test_qvec_launch_passes_the_plan(monkeypatch, bh, tq, tk, d):
    """The qvec wrapper hands build.launch the shape ints (BH, Tq, Tk,
    d) and qvec_plan's six, in the order build.SIGNATURES declares, the
    int32 query bases, and the [BH, Tq, slices, d] and [BH, Tq, slices,
    2] workspaces where there is more than one slice; the plan is the
    same at any BH."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: calls.append((name, a)))
    sig = build.SIGNATURES["ptt_flash_attention_qvec"]
    ints = [i for i, kind in enumerate(sig[:-1]) if kind is build._I]
    kv = torch.ones(bh, tk, d)
    flash_attention_qvec(torch.ones(bh, tq, d), kv, kv,
                         torch.zeros(bh, dtype=torch.long))
    name, args = calls[-1]
    plan = fa_mod.qvec_plan(tk, d)
    assert name == "ptt_flash_attention_qvec"
    assert len(args) + 1 == len(sig)  # launch appends the stream
    assert tuple(args[i] for i in ints) == (bh, tq, tk, d) + tuple(plan)
    assert args[3].dtype == torch.int32
    part_o, part_ml = args[6], args[7]
    if plan.slices > 1:
        assert part_o.shape == (bh, tq, plan.slices, d)
        assert part_ml.shape == (bh, tq, plan.slices, 2)
    else:
        assert part_o is None and part_ml is None


def test_based_kernels_take_the_query_base_on_the_device(monkeypatch):
    """On the kernel path the piece passes its offset as a one-element
    int32 tensor read at stride 0 (Tq != Tk allowed under causal), the
    qvec backward its [BH] bases at stride 1, and the qvec forward asks
    for the lse only where a gradient is wanted; each counts its own
    launches."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: launched.append((name, args)))
    q, k = torch.ones(2, 4, 64), torch.ones(2, 6, 64)
    lse = torch.zeros(2, 4)
    before = {f.__name__: f.launches for f in _LAUNCHED}
    flash_attention_piece_fwd(q, k, k, True, None, torch.tensor([2]))
    flash_attention_piece_dkv(q, k, k, lse, q, lse, True, None,
                              torch.tensor([2]))
    flash_attention_qvec_dq(q, k, k, lse, q, lse, torch.tensor([1, 2]))
    name, args = launched[0]
    assert name == "ptt_flash_attention_fwd"
    assert args[4].dtype == torch.int32 and args[4].tolist() == [2]
    # BH, Tq, Tk, d, the form (flash_plan), causal, stride
    tc, simt = fa_mod.FLASH_TC, fa_mod.FLASH_SIMT
    assert args[7:14] == (2, 4, 6, 64, tc, 1, 0)
    name, args = launched[1]
    assert name == "ptt_flash_attention_dkv" and args[4].tolist() == [2]
    assert args[11:18] == (2, 4, 6, 64, tc, 1, 0)
    name, args = launched[2]
    assert name == "ptt_flash_attention_dq" and args[4].tolist() == [1, 2]
    assert args[9:16] == (2, 4, 6, 64, simt, 1, 1)
    qs = torch.tensor([1, 2])
    flash_attention_qvec(q, k, k, qs)
    assert launched[-1][0] == "ptt_flash_attention_qvec"
    assert launched[-1][1][5] is None  # no lse on the serving path
    flash_attention_qvec(q.clone().requires_grad_(), k, k, qs)
    assert launched[-1][1][5].shape == (2, 4)
    after = {f.__name__: f.launches for f in _LAUNCHED}
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"flash_attention_piece_fwd": 1, "flash_attention_piece_dkv": 1,
            "flash_attention_qvec_dq": 1, "flash_attention_qvec": 2}
    with pytest.raises(ValueError, match="query base"):
        flash_attention_piece_fwd(q, k, k, True, None, torch.tensor([1, 2, 3]))


@pytest.mark.cuda
def test_based_kernels_match_plain_on_the_card():
    """On a CUDA card: B9's forward (o, lse) and backward (with an lse
    cotangent) at a ragged shape and offsets 0 and 500, and B8's
    backward at mixed per-row bases, against the plain versions (1e-4 of
    each output's largest magnitude), reruns bit-equal.  Skips without a
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731

    def close(got, want):
        err = (got - want).abs().max() / want.abs().max().clamp_min(1e-30)
        assert float(err) <= 1e-4

    q, k, v, do = rnd(6, 37, 64), rnd(6, 1000, 64), rnd(6, 1000, 64), \
        rnd(6, 37, 64)
    dlse = rnd(6, 37)
    for off in (0, 500):
        qoff = torch.tensor([off], device=dev)
        o, lse = flash_attention_piece_fwd(q, k, v, True, None, qoff)
        p_o, p_lse = flash_attention_piece_plain(q, k, v, True, None, qoff)
        close(o, p_o)
        close(lse, p_lse)
        _, vjp = torch.func.vjp(
            lambda a, b, c: flash_attention_piece(a, b, c, True, None, qoff),
            q, k, v)
        grads = vjp((do, dlse))
        for got, want in zip(grads, flash_attention_piece_grad_plain(
                q, k, v, o, lse, do, dlse, True, None, qoff)):
            close(got, want)
        assert all(torch.equal(a, b) for a, b in zip(grads, vjp((do, dlse))))
    qs = torch.tensor([0, 500, 1000 - 37, 3, 250, 999 - 37], device=dev)
    _, vjp = torch.func.vjp(lambda a, b, c: flash_attention_qvec(a, b, c, qs),
                            q, k, v)
    o, lse = flash_attention_plain(q, k, v, None, True, None, qs)
    delta = (do * o).sum(-1)
    want = flash_attention_grad_plain(q, k, v, None, lse, do, delta, True,
                                      None, qs)
    for got, w in zip(vjp(do), want):
        close(got, w)


# ---------------------------------------------------------------------------
# matmul_swiglu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N,bm,bn", [
    (24, 40, 48, 8, 48),
    (21, 19, 15, 7, 5),   # no dimension a multiple of the CUDA tile
    (1, 33, 70, 1, 35),   # one row (a one-slot serving step)
])
def test_matmul_swiglu_matches_reference_kernel(M, K, N, bm, bn):
    """The plain version against the reference's matmul_swiglu (Pallas
    interpret mode), and the autograd wrapper's vjp against the
    reference's custom vjp and jax.vjp of _swiglu_dense, on ragged
    shapes.  rtol = atol = 1e-5."""
    rng = np.random.RandomState(34)
    x = rng.randn(M, K).astype("float32")
    wg = (rng.randn(K, N) * K ** -0.5).astype("float32")
    wu = (rng.randn(K, N) * K ** -0.5).astype("float32")
    dy = rng.randn(M, N).astype("float32")
    args = (jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    out_r, vjp_r = jax.vjp(lambda a, b, c: pk.matmul_swiglu(a, b, c, bm, bn),
                           *args)
    _, vjp_d = jax.vjp(pk._swiglu_dense, *args)
    plain = matmul_swiglu_plain(_t(x), _t(wg), _t(wu))
    np.testing.assert_allclose(plain.numpy(), np.asarray(out_r), **TOL)
    out, vjp_t = torch.func.vjp(matmul_swiglu, _t(x), _t(wg), _t(wu))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    for got, kern, dense in zip(vjp_t(_t(dy)), vjp_r(jnp.asarray(dy)),
                                vjp_d(jnp.asarray(dy))):
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(dense), **TOL)


def test_matmul_swiglu_kernel_path_checks(monkeypatch):
    """On the kernel path the wrapper refuses bf16 and mismatched
    weights, and launches with (M, N, K) into a fresh [M, N] output that
    carries a grad_fn."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: launched.append((name, args[4:])))
    x, w = torch.ones(5, 12), torch.ones(12, 7, requires_grad=True)
    with pytest.raises(TypeError, match="float32"):
        matmul_swiglu(x.bfloat16(), w.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        matmul_swiglu(x, w, torch.ones(12, 6))
    with pytest.raises(ValueError, match="shapes"):
        matmul_swiglu(x, torch.ones(11, 7), torch.ones(11, 7))
    before = matmul_swiglu.launches
    out = matmul_swiglu(x, w, w)
    assert launched == [("ptt_matmul_swiglu",
                         (5, 7, 12) + tuple(mm_plan(5, 7, 12, gated=True)))]
    assert out.shape == (5, 7) and out.grad_fn is not None
    assert matmul_swiglu.launches == before + 1


def test_matmul_bias_act_kernel_path_checks(monkeypatch):
    """On the kernel path matmul_bias_act refuses mismatched shapes and
    launches with (M, N, K, act code) and then mm_plan's five ints, in
    build.SIGNATURES' order, into a fresh [M, N] output that carries a
    grad_fn; the bias (or None) is the third pointer."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: launched.append((name, args)))
    x, w = torch.ones(37, 1000), torch.ones(1000, 333, requires_grad=True)
    b = torch.ones(333)
    with pytest.raises(ValueError, match="shapes"):
        matmul_bias_act(x, torch.ones(999, 333), b, "gelu")
    with pytest.raises(ValueError, match="shapes"):
        matmul_bias_act(x, w, torch.ones(332), "gelu")
    before = matmul_bias_act.launches
    out = matmul_bias_act(x, w, b, "gelu")
    matmul_bias_act(x[:4], w, None, "")
    assert [name for name, _ in launched] == ["ptt_matmul_bias_act"] * 2
    for (_, args), (m, act, bias) in zip(launched, ((37, 4, b), (4, 0, None))):
        assert len(args) + 1 == len(build.SIGNATURES["ptt_matmul_bias_act"])
        assert args[0].shape == (m, 1000) and args[1] is w and args[2] is bias
        assert args[3].shape == (m, 333)
        assert args[4:] == (m, 333, 1000, act) + tuple(mm_plan(m, 333, 1000))
    assert out.shape == (37, 333) and out.grad_fn is not None
    assert matmul_bias_act.launches == before + 2
    assert mm_plan(37, 333, 1000).form == TILED
    assert mm_plan(4, 333, 1000).form == SKINNY


# (M, K, N, gated): every shape chip_smoke.py hands matmul_bias_act and
# matmul_swiglu on a path (serving, WMT, GPT-2, TinyLlama widths, BERT, the
# decode, beam and prefill steps), then the plan's edges
MM_PATH_SHAPES = [
    (128, 768, 3072, False), (128, 3072, 768, False),
    (4096, 512, 2048, False), (4096, 2048, 512, False),
    (8192, 768, 3072, False), (8192, 3072, 768, False),
    (4096, 5632, 2048, False), (128, 5632, 2048, False),
    (4096, 768, 3072, False), (4096, 3072, 768, False),
    (4096, 768, 768, False), (32, 768, 768, False), (32, 768, 2, False),
    (4, 768, 3072, False), (4, 3072, 768, False), (256, 768, 3072, False),
    (256, 3072, 768, False), (8, 768, 3072, False), (8, 3072, 768, False),
    (512, 768, 3072, False), (512, 3072, 768, False),
    (2, 5632, 2048, False), (256, 5632, 2048, False),
    (4096, 2048, 5632, True), (128, 2048, 5632, True),
    (2, 2048, 5632, True), (256, 2048, 5632, True), (200, 1000, 333, True)]
MM_EDGE_SHAPES = [
    (1, 768, 3072, False), (16, 768, 3072, False), (17, 768, 3072, False),
    (1, 2048, 5632, True), (16, 2048, 5632, True), (17, 2048, 5632, True),
    (4, 3072, 768, False), (2, 2048, 333, True), (37, 1000, 70, False),
    (45, 1600, 90, False), (16, 1000, 333, False), (3, 100, 70, False),
    (37, 100, 2, False), (5, 0, 7, False), (0, 64, 64, True),
    (21, 19, 15, True), (70000, 64, 64, False)]


def _mm_blocks(plan, M, N):
    rows = 1 if plan.form == SKINNY else -(-M // plan.bm)
    return rows * -(-N // plan.bn) * plan.slices


def _mm_tiled_time(M, N, K, bm, bn, per_sm, rate, slices):
    """The tiled plan's counted time, as mm_plan's docstring states it:
    whole waves of the clusters the card holds at once, each wave the
    tile's area x (k_slice + BLOCK_K) x blocks an SM / the tile's rate;
    k_slice the depth of the widest slice."""
    k_slice = -(-K // slices)
    k_slice = max(32, -(-k_slice // 32) * 32)
    tiles = -(-M // bm) * -(-N // bn)
    at_once = me.CLUSTER_BLOCKS[per_sm][slices - 1] // slices
    return -(-tiles // at_once) * per_sm * bm * bn * (k_slice + 128) * 100 / rate


@pytest.mark.parametrize("M,K,N,gated", MM_PATH_SHAPES + MM_EDGE_SHAPES)
def test_mm_plan_covers_k_once_and_takes_the_least_time(M, K, N, gated):
    """matmul_bias_act's and matmul_swiglu's plan: skinny exactly for
    M <= 16 (its rows the next power of two >= M), else the tiled form
    on a tile of whole warps (32 rows each); K slices of a multiple of
    the 32-deep stage that cover every k once in ascending order, none
    empty, at most 8 (a portable cluster), at least 256 deep but one; of
    every tile and slice count the least counted time (cluster waves on
    the card); a shape whose large tiles alone fill the card keeps at
    least one wave; the same plan again."""
    p = mm_plan(M, N, K, gated)
    assert mm_plan(M, N, K, gated) == p
    if M <= 16:
        assert p.form == SKINNY and p.bn in (32, 64, 128)
        assert p.bm in (1, 2, 4, 8, 16) and M <= p.bm and (
            p.bm == 1 or p.bm // 2 < M)
    else:
        assert p.form == TILED and p.bm % 32 == 0
        assert (p.bm, p.bn) in ([(128, 64), (64, 64)] if gated
                                else [(128, 128), (64, 64)])
        assert -(-M // p.bm) * p.bm >= M > (-(-M // p.bm) - 1) * p.bm
    assert 1 <= p.slices <= 8 and p.k_slice % 32 == 0
    assert p.slices == 1 or p.k_slice >= 256
    cuts = [(s * p.k_slice, min(K, (s + 1) * p.k_slice))
            for s in range(p.slices)]
    covered = [k for lo, hi in cuts for k in range(lo, hi)]
    assert covered == list(range(K))
    assert all(lo < hi for lo, hi in cuts) or K == 0
    if p.form == TILED:
        most = max(1, min(8, K // 256))
        times = {(bm, bn, s): _mm_tiled_time(M, N, K, bm, bn, per_sm, rate, s)
                 for bm, bn, per_sm, rate in me.TILES[gated]
                 for s in range(1, most + 1)}
        assert times[(p.bm, p.bn, p.slices)] == min(times.values())
        large = me.TILES[gated][0]
        if -(-M // large[0]) * -(-N // large[1]) >= 132:
            assert _mm_blocks(p, M, N) >= 132


def test_mm_plan_paths_fill_the_card():
    """The path shapes' plans: each uses at least 96 SMs' worth of blocks
    but the BERT pooler and NSP head (32 rows: 36 and 3 blocks) and the
    ragged matmul_swiglu check, and the skinny ones at least one wave."""
    short = {(32, 768, 768, False), (32, 768, 2, False),
             (200, 1000, 333, True)}
    for M, K, N, gated in MM_PATH_SHAPES:
        p = mm_plan(M, N, K, gated)
        blocks = _mm_blocks(p, M, N)
        if p.form == SKINNY:
            assert blocks >= 132, (M, K, N)
        else:
            assert (blocks >= 96) != ((M, K, N, gated) in short), (M, K, N)


# ---------------------------------------------------------------------------
# fused_softmax_xent: forward and backward against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,C", [
    (32, 2),      # the BERT path's NSP head
    (300, 1001),  # the kernel's warp form at its widest share (32 a lane)
    (7, 1500),    # the kernel's row form, R not a multiple of 8
    (9, 1025),    # the staged form's first width (one column past the warp's)
    (6, 4098),    # C % 4 == 2: rows alternate 0 and 8 bytes past 16
])
def test_softmax_xent_matches_reference_kernel(R, C):
    """The plain versions and the autograd wrapper (forward, and dx under
    torch.func.vjp) against the reference's fused_softmax_xent (Pallas
    interpret mode) under jax.vjp, with labels -1 and C in the batch (no
    column: the loss is the lse, the one-hot row zero).  rtol 1e-5, atol
    1e-6."""
    rng = np.random.RandomState(31)
    x = (rng.randn(R, C) * 3).astype("float32")
    lbl = rng.randint(0, C, (R,)).astype("int64")
    lbl[0], lbl[-1] = -1, C
    dy = rng.rand(R, 1).astype("float32")
    tol = dict(rtol=1e-5, atol=1e-6)

    loss_r, vjp = jax.vjp(
        lambda a: pk.fused_softmax_xent(a, jnp.asarray(lbl, "int32")),
        jnp.asarray(x))
    dx_r, = vjp(jnp.asarray(dy))
    lg = x.astype("float64")
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
    np.testing.assert_allclose(np.asarray(loss_r)[[0, -1], 0], lse[[0, -1]],
                               rtol=1e-6)

    loss = softmax_xent_plain(_t(x), _t(lbl))
    assert loss.shape == (R, 1) and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_r), **tol)
    dx = softmax_xent_grad_plain(_t(x), _t(lbl), _t(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_r), **tol)

    # [R, 1] labels, as the op feeds them before its reshape
    out, vjp_t = torch.func.vjp(
        lambda a: fused_softmax_xent(a, _t(lbl[:, None])), _t(x))
    dx_t, = vjp_t(_t(dy))
    np.testing.assert_allclose(out.numpy(), np.asarray(loss_r), **tol)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_r), **tol)
    np.testing.assert_array_equal(dx_t.numpy(), dx.numpy())


@pytest.mark.parametrize("logits,labels,match", [
    (torch.zeros(2, 3, 4), torch.zeros(6, dtype=torch.long), "2-D"),
    (torch.zeros(4, 3), torch.zeros(3, dtype=torch.long), r"\[rows\]=4"),
    (torch.zeros(4, 3), torch.zeros(4, 2, dtype=torch.long), r"\[rows\]=4"),
    (torch.zeros(4, 3), torch.zeros(1, 4, 1, dtype=torch.long),
     r"\[rows\]=4"),
    (torch.zeros(4, 3), torch.zeros(4), "integers"),
    (torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool), "integers"),
])
def test_softmax_xent_shape_contract_is_loud(logits, labels, match):
    """The reference's _sxent_validate errors, on any device."""
    with pytest.raises(ValueError, match=match):
        fused_softmax_xent(logits, labels)


def test_softmax_xent_kernel_path_checks(monkeypatch):
    """On the kernel path each wrapper refuses bf16, labels that are not
    contiguous int64 and a dy of the wrong size, and launches with (R, C)
    into fresh outputs; the autograd wrapper's backward launches the
    backward kernel, counted once."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: launched.append((name, args[-2:])))
    x, lbl = torch.ones(5, 3), torch.zeros(5, dtype=torch.long)
    with pytest.raises(TypeError, match="float32"):
        softmax_xent_fwd(x.bfloat16(), lbl)
    with pytest.raises(TypeError, match="int64"):
        softmax_xent_fwd(x, lbl.int())
    with pytest.raises(TypeError, match="int64"):
        softmax_xent_fwd(x, torch.zeros(10, dtype=torch.long)[::2])
    with pytest.raises(ValueError, match="shapes"):
        softmax_xent_bwd(x, lbl, torch.ones(4, 1))
    with pytest.raises(ValueError, match="shapes"):
        softmax_xent_fwd(torch.ones(5, 0), lbl)
    assert launched == []
    fwd0, bwd0 = softmax_xent_fwd.launches, softmax_xent_bwd.launches
    loss = softmax_xent_fwd(x, lbl)
    assert loss.shape == (5, 1) and launched == [("ptt_softmax_xent_fwd",
                                                  (5, 3))]
    xg = x.clone().requires_grad_()
    out = fused_softmax_xent(xg, lbl[:, None])
    (dx,) = torch.autograd.grad(out.sum(), (xg,))
    assert dx.shape == (5, 3)
    assert [n for n, _ in launched] == ["ptt_softmax_xent_fwd"] * 2 + [
        "ptt_softmax_xent_bwd"]
    assert softmax_xent_fwd.launches == fwd0 + 2
    assert softmax_xent_bwd.launches == bwd0 + 1


@pytest.mark.parametrize("R", [1, 8, 264, 8192])
def test_sxent_plan_takes_every_width(R):
    """sxent_plan takes every C from 1 to 70000, the staged form's widest
    and the two-read form's up to 2**31 - 1, and raises past it: the warp
    form to 1024 columns; the staged form to
    STAGED_MAX_C, at the fewest
    blocks a row whose parts (a multiple of 4) hold at most PART_FLOATS
    (8 past that), each column in exactly one part, whole warps of
    MIN_THREADS to 1024 threads, and a stage of the part plus 3 floats of slack that
    fits the STAGE_BYTES the kernel raises its limit to; the two-read
    form beyond; the same form at every R."""
    widths = list(range(1, 70001)) + [sx_mod.STAGED_MAX_C - 1,
                                      sx_mod.STAGED_MAX_C,
                                      sx_mod.STAGED_MAX_C + 1, 2 ** 31 - 1]
    for C in widths:
        plan = sx_mod.sxent_plan(R, C)
        assert plan == sx_mod.sxent_plan(1, C), C
        if C <= sx_mod.WARP_MAX_C:
            assert plan == (sx_mod.WARP, 0, 0, 0), C
            continue
        if C > sx_mod.STAGED_MAX_C:
            assert plan == (sx_mod.TWO_READ, 0, 0, 0), C
            continue
        assert plan.form == sx_mod.STAGED, C
        assert plan.ctas in sx_mod.CTAS, C
        part = plan.smem // 4 - 4
        assert part % 4 == 0 and part >= -(-C // plan.ctas) > part - 4, C
        assert (plan.ctas - 1) * part < C <= plan.ctas * part, C
        assert part <= sx_mod.PART_FLOATS or plan.ctas == sx_mod.CTAS[-1], C
        assert all(-(-C // n) > sx_mod.PART_FLOATS
                   for n in sx_mod.CTAS if n < plan.ctas), C
        assert plan.threads % 32 == 0, C
        assert sx_mod.MIN_THREADS <= plan.threads <= 1024, C
        assert plan.smem <= sx_mod.STAGE_BYTES, C
    for C in (0, 2 ** 31):
        with pytest.raises(ValueError, match=r"\[%d, %d\]" % (R, C)):
            sx_mod.sxent_plan(R, C)


def test_softmax_xent_launch_passes_the_plan(monkeypatch):
    """Both kernels' wrappers hand build.launch sxent_plan's four ints,
    then (R, C), in the order build.SIGNATURES declares, at each form
    (warp, staged at 1, 2 and 4 blocks a row, two-read, and
    a view that does not start on 16 bytes: the staged form takes any
    start)."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: calls.append((name, a)))
    for name, fn in (("ptt_softmax_xent_fwd", softmax_xent_fwd),
                     ("ptt_softmax_xent_bwd", softmax_xent_bwd)):
        sig = build.SIGNATURES[name]
        ints = [i for i, kind in enumerate(sig[:-1]) if kind is build._I]
        off = torch.ones(2 * 4098 + 1)[1:].view(2, 4098)
        for x in (torch.ones(32, 2), torch.ones(5, 1024), torch.ones(5, 1025),
                  torch.ones(2, 4098), torch.ones(3, 30522),
                  torch.ones(2, sx_mod.PART_FLOATS + 1),
                  torch.ones(2, 2 * sx_mod.PART_FLOATS + 1),
                  torch.ones(2, sx_mod.STAGED_MAX_C + 1), off):
            R, C = x.shape
            lbl = torch.zeros(R, dtype=torch.long)
            fn(x, lbl, *(() if "fwd" in name else (torch.ones(R, 1),)))
            got, args = calls[-1]
            assert got == name and len(args) + 1 == len(sig)
            assert tuple(args[i] for i in ints) == tuple(
                sx_mod.sxent_plan(R, C)) + (R, C)
    forms = {sx_mod.sxent_plan(2, C)[:2] for C in (
        2, 1024, 1025, sx_mod.PART_FLOATS + 1, 2 * sx_mod.PART_FLOATS + 1,
        sx_mod.STAGED_MAX_C + 1)}
    assert forms == {(sx_mod.WARP, 0), (sx_mod.STAGED, 1),
                     (sx_mod.STAGED, 2), (sx_mod.STAGED, 4),
                     (sx_mod.TWO_READ, 0)}
