"""paddle_tpu_torch kernels: each plain PyTorch version against the JAX
entry point it replaces, run as tests/test_pallas_kernels.py runs it
(Pallas interpret mode on the CPU), forward and, through the wrappers'
``torch.autograd.Function``s under ``torch.func.vjp``, backward against
the reference's ``jax.vjp``; plus the wrappers' dispatch rules: CPU and
meta tensors take the plain version without counting a launch, and the
kernel path raises rather than falling back.

Tolerance: rtol = atol = 1e-5 in float32 — the two sides sum in
different orders (XLA vs PyTorch CPU kernels), nothing else differs."""

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
    assert args[7:13] == (2, 4, 6, 64, 1, 0)  # BH, Tq, Tk, d, causal, stride
    name, args = launched[1]
    assert name == "ptt_flash_attention_dkv" and args[4].tolist() == [2]
    assert args[11:17] == (2, 4, 6, 64, 1, 0)
    name, args = launched[2]
    assert name == "ptt_flash_attention_dq" and args[4].tolist() == [1, 2]
    assert args[9:15] == (2, 4, 6, 64, 1, 1)
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
    assert launched == [("ptt_matmul_swiglu", (5, 7, 12))]
    assert out.shape == (5, 7) and out.grad_fn is not None
    assert matmul_swiglu.launches == before + 1


# ---------------------------------------------------------------------------
# fused_softmax_xent: forward and backward against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,C", [
    (32, 2),      # the BERT path's NSP head
    (300, 1001),  # the kernel's warp form at its widest share (32 a lane)
    (7, 1500),    # the kernel's row form, R not a multiple of 8
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
