"""bf16 flash attention (B3) and SwiGLU (B6) in the port, against the
reference.

- The plain versions follow the Pallas kernels in bf16: q, k and v are
  widened to float32 before the score product, p (and dS) stay float32
  for the second products, and o, dq, dk, dv are rounded once.  The
  forward at [4, 128, 64], causal, equals ``pk.flash_attention`` in
  interpret mode in at least 99.9% of o's elements and is within 2^-8
  of |o|'s largest value everywhere (rounding p to bf16 before p v, as
  the reference's dense path does, differs in about half of them).
- B3's bf16 plain forward (o and the float32 lse) and the autograd
  wrapper's gradients (dq, dk, dv and the float32 dkbias, under
  ``torch.func.vjp``) against ``pk._flash_fwd`` and ``jax.vjp`` of
  ``pk.flash_attention`` in interpret mode: causal with a key bias, a
  window with segment ids, Tq != Tk with a key-padding bias.  Each bf16
  output within one bf16 unit in the last place of its largest
  magnitude (both round a float32 value that differs in its last bits,
  and a rounding may go the other way at any element), the lse within
  1e-5 relative, dkbias within 1e-4 of its largest magnitude.
- B6's bf16 plain form and its vjp against ``pk.matmul_swiglu``.
- The dtype rule of the new ``BF16_FORMS`` entries, with their float32
  operands (the key bias after the rows, the saved lse and delta), the
  bf16 entry points reached through a spied ``build.launch`` and their
  own counters, and the refusals that name their ROADMAP queue (a bf16
  q to B3's few-row form, B9 and B8: B8q); B12's bf16 forms take bf16 x
  and w_local with a float32 row validity, lse and dy.
- Three bf16 Adam steps of a tiny GPT-2 (d_model 128, 2 heads of 64), a
  tiny modern decoder (SwiGLU, rotary, grouped-query attention) and a
  tiny BERT with ``fused_attn`` against the reference under
  ``use_pallas`` (its kernels in interpret mode), at test_torch_amp.py's
  tolerances: losses at rtol 5e-3, each updated tensor's change within
  a relative L2 distance of 0.6 of the reference's.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import gpt2 as ref_gpt2
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.kernels import build, matmul_swiglu_plain
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import gpt2 as port_gpt2

from test_torch_amp import _held, _with_pallas

fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
msw = importlib.import_module("paddle_tpu_torch.kernels.matmul_swiglu")

BATCH, SEQ = 2, 16


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


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    """A numpy or jax array as a torch tensor of its dtype (bf16 through
    float32, exactly)."""
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _within_one_unit(got, want):
    """got (torch, bf16) within one bf16 unit in the last place of want's
    (jax, bf16) largest magnitude, elementwise."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want.astype(jnp.float32), np.float64)
    top = np.abs(w).max()
    unit = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    assert np.abs(g - w).max() <= unit, (np.abs(g - w).max(), unit)


# ---------------------------------------------------------------------------
# C11: the plain forward follows the Pallas kernel in bf16
# ---------------------------------------------------------------------------
def test_bf16_plain_forward_follows_the_pallas_kernel():
    rng = np.random.RandomState(0)
    q, k, v = (_bf(rng.randn(4, 128, 64).astype("float32")) for _ in range(3))
    want = np.asarray(pk.flash_attention(q, k, v, None, True, 0.125, 128, 128)
                      .astype(jnp.float32))
    o, _ = fa.flash_attention_plain(_t(q), _t(k), _t(v), None, True, 0.125)
    got = o.float().numpy()
    assert o.dtype == torch.bfloat16
    assert (got == want).mean() >= 0.999, (got != want).mean()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


# ---------------------------------------------------------------------------
# B3's bf16 form: the plain forward and the wrapper's gradients
# ---------------------------------------------------------------------------
def _flash_case(case, rng):
    """(bh, tq, tk, causal, kbias, window, seg, block)"""
    bh, d = 2, 64
    if case == "causal_key_bias":
        kb = rng.randn(bh, 128).astype("float32")
        return bh, 128, 128, d, True, kb, 0, None, 64
    if case == "window_segment_ids":
        seg = np.zeros((bh, 128), "int32")
        seg[0, 40:], seg[0, 90:], seg[1, 70:] = 1, 2, 1
        return bh, 128, 128, d, True, None, 48, seg, 64
    kb = np.zeros((bh, 128), "float32")
    kb[0, 100:], kb[1, 60:] = -1e9, -1e9  # padded keys
    return bh, 64, 128, d, False, kb, 0, None, 64


@pytest.mark.parametrize("case", ["causal_key_bias", "window_segment_ids",
                                  "cross_key_padding"])
def test_flash_attention_bf16_plain_matches_pallas(case):
    rng = np.random.RandomState(7)
    bh, tq, tk, d, causal, kb, window, seg, blk = _flash_case(case, rng)
    q = _bf(rng.randn(bh, tq, d).astype("float32"))
    k, v = (_bf(rng.randn(bh, tk, d).astype("float32")) for _ in range(2))
    do = _bf(rng.randn(bh, tq, d).astype("float32"))
    scale = d ** -0.5
    jseg = None if seg is None else jnp.asarray(seg)
    jkb = jnp.zeros((bh, tk), jnp.float32) if kb is None else jnp.asarray(kb)
    r_o, r_lse = pk._flash_fwd(q, k, v, jkb, causal, scale, blk, blk, window,
                               seg=jseg)
    prim = (q, k, v) + (() if kb is None else (jkb,))
    _, vjp = jax.vjp(lambda *a: pk.flash_attention(
        *a[:3], a[3] if len(a) > 3 else None, causal, scale, blk, blk, window,
        jseg), *prim)
    r_grads = vjp(do)

    tkb = None if kb is None else torch.from_numpy(kb)
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), tkb, causal, scale,
                                      None, window, tseg)
    _within_one_unit(o, r_o)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), rtol=1e-5)
    tprim = (_t(q), _t(k), _t(v)) + (() if kb is None else (tkb,))
    out, vjp_t = torch.func.vjp(lambda *a: fa.flash_attention(
        *a[:3], a[3] if len(a) > 3 else None, causal, scale, window, tseg),
        *tprim)
    assert torch.equal(out, o)
    grads = vjp_t(_t(do))
    assert len(grads) == len(r_grads)
    for got, want in zip(grads[:3], r_grads[:3]):
        _within_one_unit(got, want)
    if kb is not None:
        want = np.asarray(r_grads[3])
        assert grads[3].dtype == torch.float32
        assert np.abs(grads[3].numpy() - want).max() <= 1e-4 * np.abs(
            want).max()


# ---------------------------------------------------------------------------
# B6's bf16 form
# ---------------------------------------------------------------------------
def test_matmul_swiglu_bf16_plain_matches_pallas():
    """silu(x wg) (x wu) in float32, rounded once; the backward the dense
    recompute on the widened operands, each grad rounded once."""
    rng = np.random.RandomState(11)
    x = _bf(rng.randn(64, 96).astype("float32"))
    wg, wu = (_bf(rng.randn(96, 80).astype("float32") * 96 ** -0.5)
              for _ in range(2))
    dy = _bf(rng.randn(64, 80).astype("float32"))
    want, vjp = jax.vjp(lambda *a: pk.matmul_swiglu(*a), x, wg, wu)
    _within_one_unit(matmul_swiglu_plain(_t(x), _t(wg), _t(wu)), want)
    out, vjp_t = torch.func.vjp(msw.matmul_swiglu, _t(x), _t(wg), _t(wu))
    _within_one_unit(out, want)
    for got, r in zip(vjp_t(_t(dy)), vjp(dy)):
        _within_one_unit(got, r)


# ---------------------------------------------------------------------------
# the dtype rule and the bf16 entry points
# ---------------------------------------------------------------------------
def test_bf16_forms_of_attention_and_swiglu_take_their_float32_operands():
    bf, f32 = torch.bfloat16, torch.float32
    q, row = torch.zeros(2, 8, 64, dtype=bf), torch.zeros(2, 8, dtype=f32)
    build.check_inputs("flash_attention_fwd", q, q, q)
    build.check_inputs("flash_attention_fwd", q, q, q, row)  # key bias
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        build.check_inputs(name, q, q, q, row, q, row)
        build.check_inputs(name, q, q, q, row, q, row, row)
        with pytest.raises(build.KernelTypeError, match="operand 3"):
            build.check_inputs(name, q, q, q, row.to(bf), q, row)
        with pytest.raises(build.KernelTypeError, match="operand 4"):
            build.check_inputs(name, q, q, q, row, q.float(), row)
        with pytest.raises(build.KernelTypeError, match="operand 6"):
            build.check_inputs(name, q, q, q, row, q, row, row.to(bf))
    with pytest.raises(build.KernelTypeError, match="operand 3"):
        build.check_inputs("flash_attention_fwd", q, q, q, row.to(bf))
    x = torch.zeros(4, 8, dtype=bf)
    build.check_inputs("matmul_swiglu", x, x, x)
    with pytest.raises(build.KernelTypeError, match="operand 1"):
        build.check_inputs("matmul_swiglu", x, x.float(), x)
    for name, queue in (("flash_attention_fwd_rows", "B8q"),
                        ("flash_attention_piece_fwd", "B8q"),
                        ("flash_attention_qvec", "B8q"),
                        ("flash_attention_qvec_dkv", "B8q"),
                        ("softmax_xent_fwd", "ROADMAP B")):
        with pytest.raises(build.KernelTypeError, match=queue):
            build.check_inputs(name, x, x)
    # B12's bf16 forms (no longer queued): bf16 x and w_local, the row
    # validity, lse and dy float32
    row = torch.zeros(4, dtype=f32)
    build.check_inputs("linear_xent_parts", x, x)
    for name in ("linear_xent_dx_sharded", "linear_xent_dw_sharded"):
        build.check_inputs(name, x, x, row, row[:, None], row[:, None])
        with pytest.raises(build.KernelTypeError, match="operand 2"):
            build.check_inputs(name, x, x, row.to(bf), row[:, None],
                               row[:, None])


def test_bf16_attention_and_swiglu_launch_their_own_entry_points(monkeypatch):
    """bf16 inputs reach the three flash entry points' bf16 forms with
    flash_plan's form and the float32 forms' other ints, and
    matmul_swiglu's with mm_plan(gated, bf16)'s tiled plan, each counted
    under its bf16 name; the float32 counters do not move; B3's few-row
    form and B9 refuse a bf16 q before any launch (B8q)."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: calls.append((name, args)))
    bf = torch.bfloat16
    q = torch.randn(4, 96, 64).to(bf)
    kb, lse = torch.zeros(4, 96), torch.zeros(4, 96)
    counters = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv, fa.flash_attention_fwd_bf16,
                fa.flash_attention_dq_bf16, fa.flash_attention_dkv_bf16,
                msw.matmul_swiglu, msw.matmul_swiglu_bf16)
    before = {f.__name__: f.launches for f in counters}
    fa.flash_attention_fwd(q, q, q, kb, False, 0.125)
    fa.flash_attention_dq(q, q, q, None, lse, q, lse, True, 0.125)
    fa.flash_attention_dkv(q, q, q, kb, lse, q, lse, False, 0.125)
    x, w = torch.randn(200, 64).to(bf), torch.randn(64, 48).to(bf)
    msw.matmul_swiglu(x, w, w)
    assert [c[0] for c in calls] == [
        "ptt_flash_attention_fwd_bf16", "ptt_flash_attention_dq_bf16",
        "ptt_flash_attention_dkv_bf16", "ptt_matmul_swiglu_bf16"]
    # BH, Tq, Tk, d, the form, causal
    assert list(calls[0][1][7:13]) == [4, 96, 96, 64, fa.FLASH_TC, 0]
    assert list(calls[1][1][9:15]) == [4, 96, 96, 64, fa.FLASH_TC, 1]
    assert list(calls[3][1][-5:]) == list(msw.mm_plan(200, 48, 64, gated=True,
                                                      bf16=True))
    after = {f.__name__: f.launches for f in counters}
    assert {k: after[k] - before[k] for k in after} == {
        "flash_attention_fwd": 0, "flash_attention_dq": 0,
        "flash_attention_dkv": 0, "flash_attention_fwd_bf16": 1,
        "flash_attention_dq_bf16": 1, "flash_attention_dkv_bf16": 1,
        "matmul_swiglu": 0, "matmul_swiglu_bf16": 1}
    with pytest.raises(build.KernelTypeError, match="B8q"):
        fa.flash_attention_fwd(q[:, :4], q, q, kb)  # the few-row form
    with pytest.raises(build.KernelTypeError, match="B8q"):
        fa.flash_attention_piece_fwd(q, q, q, True, 0.125,
                                     torch.zeros(1, dtype=torch.int32))
    assert len(calls) == 4


# ---------------------------------------------------------------------------
# bf16 training against the reference
# ---------------------------------------------------------------------------
_GPT2 = dict(vocab_size=61, n_ctx=32, d_model=128, n_layer=1, n_head=2,
             dropout=0.0)
_MODERN = dict(_GPT2, n_kv_head=1, use_rotary=True, use_swiglu=True,
               ffn_multiple_of=8)
_BERT = dict(vocab_size=61, d_model=128, n_layer=1, n_head=2, d_inner_hid=256,
             max_position=SEQ, dropout=0.0, fused_attn=True)


def _build(model, pkg):
    """(main, startup, fetch, batch) of `model` in package `pkg` (the
    reference's or the port's module set) with use_bf16."""
    gpt2, bert = pkg
    if model == "bert":
        hp = type("Tiny", (bert.BertConfig,), _BERT)
        main, start, _, fetch = bert.bert_pretrain_program(
            hp, seq_len=SEQ, lr=1e-3, use_bf16=True)
        return main, start, fetch, ref_bert.make_fake_bert_batch(
            BATCH, SEQ, hp, seed=2)
    hp = type("Tiny", (gpt2.GPT2Config,), _GPT2 if model == "gpt2"
              else _MODERN)
    main, start, _, fetch = gpt2.gpt2_lm_program(hp, seq_len=SEQ, lr=1e-3,
                                                 use_bf16=True)
    return main, start, fetch, ref_gpt2.make_fake_lm_batch(BATCH, SEQ, hp,
                                                           seed=2)


@pytest.mark.parametrize("model", ["gpt2", "gpt2_modern", "bert"])
def test_bf16_training_with_flash_attention_matches_reference(model):
    """Three Adam steps from the reference's startup arrays; the master
    weights and Adam moments stay float32."""

    def reference():
        with fluid.unique_name.guard():
            main, start, fetch, batch = _build(model, (ref_gpt2, ref_bert))
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(start)
            names = [n for n, v in start.global_block().vars.items()
                     if v.persistable]
            init = {n: np.asarray(scope.find_var(n)) for n in names}
            losses = [float(np.asarray(exe.run(
                main, feed=batch, fetch_list=[fetch[0]])[0]).sum())
                for _ in range(3)]
            final = {n: np.asarray(scope.find_var(n)) for n in names}
        return init, losses, final

    init, r_losses, r_final = _with_pallas(reference)
    with unique_name.guard():
        main, _, fetch, batch = _build(model, (port_gpt2, port_bert))
    types = {op.type for op in main.global_block().ops}
    assert "fused_attention" in types
    assert ("fused_swiglu" in types) == (model == "gpt2_modern")
    q_name = next(op.inputs["Q"][0] for op in main.global_block().ops
                  if op.type == "fused_attention")
    assert main.global_block().var(q_name).dtype == "bfloat16"
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        losses = [float(exe.run(main, feed=batch, fetch_list=[fetch[0]])[0]
                        .sum()) for _ in range(3)]
    _held(r_losses, losses, init, r_final, scope)
    assert all(scope.find_var(n).dtype == torch.float32
               for n in r_final if n != "@LR_DECAY_COUNTER@")
