"""bf16 automatic mixed precision in the port, against the reference.

- ``rewrite_bf16``, ``rewrite_fp16`` and ``bf16_amp_pass`` give the
  reference's programs op for op through ``Program.to_json``: the WMT
  training program (fused_attn off and on), GPT-2, BERT and ResNet-50
  (NCHW and NHWC, at 224), with their bf16 vars' dtypes; the vars agree
  up to the dtype policy (the reference declares some int64 results
  int32).
- The four bf16 kernel forms' plain versions (B5 matmul_bias_act, B1
  fused_layer_norm, B2 fused_add_layer_norm, B4 fused_linear_xent) and
  their backwards against the reference's Pallas kernels in interpret
  mode on the same bf16 operands: bf16 outputs within rtol 1e-2 (and
  1e-2 of the largest magnitude where the elementwise ratio has no
  meaning near 0), float32 outputs (B4's loss and lse, B1 / B2's
  gamma and beta grads) within rtol 1e-5.  The kernels' dtype rule:
  the bf16 forms dispatch to their bf16 entry points, every other
  kernel refuses bf16 naming ROADMAP B.
- Three bf16 training steps of a tiny one-layer WMT (fused_attn off and
  on) and of the CIFAR ResNet (depth 8 at 32 x 32, batch 4, the size
  test_torch_cnn.py trains, NCHW and NHWC) from the reference's startup
  arrays.  The master weights, Adam moments and velocities stay
  float32.  bf16 rounds at other places in the two frameworks (XLA on
  the CPU keeps some bf16 values in float32; PyTorch rounds each op's
  output), so a 1-unit difference in an activation moves a relu or a
  rounding and the optimizer carries it: the losses are held at rtol
  5e-3 (bf16's unit roundoff is 3.9e-3; 1.0e-3 measured), and each
  updated tensor's change from its start at a relative L2 distance of
  0.6 from the reference's change (0.14 measured, on a tensor whose
  gradient is near zero; a wrong cast placement or dtype moves the
  whole update).  ResNet-50 itself is not trained here: at batch 4 on
  32 x 32 its last batch norms normalize 4 values, and the reference's
  own bf16 loss differs from its float32 loss by 58%.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import flags as ref_flags
from paddle_tpu.contrib import mixed_precision as ref_mp
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import gpt2 as ref_gpt2
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import transformer as ref_tfm
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.contrib import mixed_precision as port_mp
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.kernels import add_layer_norm as aln
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import linear_xent as lx
from paddle_tpu_torch.kernels import matmul_epilogue as me
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.models import transformer as port_tfm
from paddle_tpu_torch.transpiler import pass_registry

from test_torch_cnn import _mod, _nets

SRC, TRG, BATCH = 8, 8, 4


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


def _tiny_wmt(base, **kw):
    attrs = dict(src_vocab_size=53, trg_vocab_size=61, max_length=16,
                 d_model=32, d_inner_hid=64, n_head=4, n_layer=2, dropout=0.1)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


def _tiny_gpt2(base, **kw):
    attrs = dict(vocab_size=61, n_ctx=32, d_model=64, n_layer=2, n_head=4,
                 dropout=0.0)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


# the modern-decoder options together: SwiGLU, rotary, grouped-query
MODERN = dict(n_kv_head=2, use_rotary=True, use_swiglu=True,
              ffn_multiple_of=8)


def _tiny_bert(base, **kw):
    attrs = dict(vocab_size=61, d_model=64, n_layer=2, n_head=4,
                 d_inner_hid=128, max_position=16)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


def _same_json(ref, port):
    """The ops of both programs' JSON equal, and the vars up to the dtype
    policy (int32 in the reference is int64 in the port)."""
    r, p = json.loads(ref.to_json()), json.loads(port.to_json())
    r_ops, p_ops = r["blocks"][0]["ops"], p["blocks"][0]["ops"]
    assert len(p_ops) == len(r_ops)
    for i, (a, b) in enumerate(zip(r_ops, p_ops)):
        assert b == a, "op %d differs:\nref  %s\nport %s" % (i, a, b)

    def norm(v):
        return dict(v, dtype={"int32": "int64"}.get(v["dtype"], v["dtype"]))

    r_vars, p_vars = r["blocks"][0]["vars"], p["blocks"][0]["vars"]
    assert [norm(v) for v in p_vars] == [norm(v) for v in r_vars]
    return p_ops


def _programs(model):
    """(reference main, port main) of `model` built with use_bf16."""
    if model.startswith("wmt"):
        fa = model == "wmt_fused_attn"
        return (ref_tfm.wmt_transformer_program(
                    _tiny_wmt(ref_tfm.ModelHyperParams, fused_attn=fa),
                    src_len=SRC, trg_len=TRG, use_bf16=True)[0],
                port_tfm.wmt_transformer_program(
                    _tiny_wmt(port_tfm.ModelHyperParams, fused_attn=fa),
                    src_len=SRC, trg_len=TRG, use_bf16=True)[0])
    if model.startswith("gpt2"):
        kw = MODERN if model == "gpt2_modern" else {}
        return (ref_gpt2.gpt2_lm_program(
                    _tiny_gpt2(ref_gpt2.GPT2Config, **kw), seq_len=16,
                    use_bf16=True)[0],
                port_gpt2.gpt2_lm_program(
                    _tiny_gpt2(port_gpt2.GPT2Config, **kw), seq_len=16,
                    use_bf16=True)[0])
    if model.startswith("bert"):
        kw = dict(fused_attn=model == "bert_fused_attn")
        with fluid.unique_name.guard():
            ref = ref_bert.bert_pretrain_program(
                _tiny_bert(ref_bert.BertConfig, **kw), seq_len=16,
                use_bf16=True)[0]
        with unique_name.guard():
            port = port_bert.bert_pretrain_program(
                _tiny_bert(port_bert.BertConfig, **kw), seq_len=16,
                use_bf16=True)[0]
        return ref, port
    nhwc = model == "resnet50_nhwc"
    with fluid.unique_name.guard():
        ref = ref_resnet.build_resnet_train_program(use_bf16=True,
                                                    use_nhwc=nhwc)[0]
    with unique_name.guard():
        port = port_resnet.build_resnet_train_program(use_bf16=True,
                                                      use_nhwc=nhwc)[0]
    return ref, port


@pytest.mark.parametrize("model", ["wmt", "wmt_fused_attn", "gpt2",
                                   "gpt2_modern", "bert", "bert_fused_attn",
                                   "resnet50_nchw", "resnet50_nhwc"])
def test_bf16_amp_pass_programs_match_reference(model):
    """bf16_amp_pass after the fuse passes (and rewrite_nhwc), before
    minimize: casts, @BF16 / @RAW_BF16 / @BIAS_BF16 vars, the flipped
    trunk ops and their grads, op for op; master weights float32.  The
    modern decoder's fused_swiglu and every fused_attention take bf16
    data inputs, the key bias float32."""
    ref, port = _programs(model)
    ops = _same_json(ref, port)
    block = port.global_block()
    casts = [o for o in ops if o["type"] == "cast"]
    assert casts and any(o["attrs"]["out_dtype"] == "bfloat16" for o in casts)
    assert any(n.endswith("@RAW_BF16") for n in block.vars)
    assert all(p.dtype == "float32" for p in block.all_parameters())
    if model == "wmt":
        types = [o.type for o in block.ops]
        fc = [o for o in block.ops if o.type == "fc"]
        assert all(block.var(o.inputs[s][0]).dtype == "bfloat16"
                   for o in fc for s in ("Input", "W", "Bias"))
        xent = block.ops[types.index("fused_linear_xent")]
        assert block.var(xent.inputs["X"][0]).dtype == "bfloat16"
        assert block.var(xent.inputs["Label"][0]).dtype == "int64"
    for op in block.ops:
        if op.type in ("fused_attention", "fused_swiglu"):
            data = op.inputs["Q" if op.type == "fused_attention" else "X"]
            assert block.var(data[0]).dtype == "bfloat16", op.type
            for bias in op.inputs.get("Bias", []):
                assert block.var(bias).dtype == "float32"
    if model == "gpt2_modern":
        assert any(o.type == "fused_swiglu" for o in block.ops)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_rewrites_and_their_counts_match_reference(dtype):
    """rewrite_bf16 / rewrite_fp16 on the WMT is_test program (no
    minimize), and the trunk and collapse passes' counts."""
    ref = ref_tfm.wmt_transformer_program(_tiny_wmt(ref_tfm.ModelHyperParams),
                                          src_len=SRC, trg_len=TRG,
                                          is_test=True)[0]
    port = port_tfm.wmt_transformer_program(
        _tiny_wmt(port_tfm.ModelHyperParams), src_len=SRC, trg_len=TRG,
        is_test=True)[0]
    if dtype == "bfloat16":
        counts = ref_mp.rewrite_bf16(ref), port_mp.rewrite_bf16(port)
    else:
        counts = ref_mp.rewrite_fp16(ref), port_mp.rewrite_fp16(port)
    assert counts[0] == counts[1] > 0
    _same_json(ref, port)
    tag = "@RAW_BF16" if dtype == "bfloat16" else "@RAW_FP16"
    assert any(n.endswith(tag) for n in port.global_block().vars)
    # a second pass over a rewritten program flips and drops nothing more
    assert (ref_mp.propagate_half_through_trunk(ref, dtype)
            == port_mp.propagate_half_through_trunk(port, dtype))
    assert (ref_mp.collapse_redundant_casts(ref, dtype)
            == port_mp.collapse_redundant_casts(port, dtype))


def test_bf16_amp_pass_is_registered():
    assert "bf16_amp_pass" in pass_registry.list_passes()
    prog = port_tfm.wmt_transformer_program(
        _tiny_wmt(port_tfm.ModelHyperParams), src_len=SRC, trg_len=TRG,
        is_test=True)[0]
    n_before = len(prog.global_block().ops)
    version = prog._version
    assert pass_registry.apply_pass(prog, "bf16_amp_pass") is prog
    assert len(prog.global_block().ops) > n_before
    assert prog._version > version


# ---------------------------------------------------------------------------
# the bf16 kernel forms' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    """A jax array as a torch tensor of the same dtype (bf16 through
    float32, exactly)."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _close(got, want, rtol):
    """got (torch) within rtol of want (jax) elementwise, or within rtol
    of want's largest magnitude; the same dtype."""
    want_dt = "bfloat16" if want.dtype == jnp.bfloat16 else str(want.dtype)
    assert str(got.dtype).replace("torch.", "") == want_dt
    g = got.detach().double().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    scale = max(np.abs(w).max(), 1e-30)
    assert (np.abs(g - w) <= rtol * np.maximum(np.abs(w), scale)).all(), (
        float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("act", ["relu", "gelu", ""])
def test_matmul_bias_act_bf16_plain_matches_pallas(act):
    """x, w and bias bf16 (fc's three slots under AMP): z, the bias and
    the activation in float32, one rounding; the backward as jax.vjp of
    _mm_dense (float32 dz, bf16 grads)."""
    rng = np.random.RandomState(0)
    x, w = _bf(rng.randn(64, 96)), _bf(rng.randn(96, 80) / np.sqrt(96))
    b, dy = _bf(rng.randn(80)), _bf(rng.randn(64, 80))
    out, vjp = jax.vjp(lambda a, c, d: pk.matmul_bias_act(a, c, d, act),
                       x, w, b)
    grads = vjp(dy)
    args = [_t(a).requires_grad_() for a in (x, w, b)]
    got = me.matmul_bias_act(*args, act)
    _close(got, out, 1e-2)
    for g, want in zip(torch.autograd.grad(got, args, _t(dy)), grads):
        _close(g, want, 1e-2)


def test_layer_norms_bf16_plain_match_pallas():
    """B1 and B2 on bf16 rows with float32 gamma and beta: bf16 outputs
    (B2's sum rounded from the float32 sum its statistics read),
    float32 gamma and beta grads."""
    rng = np.random.RandomState(1)
    x, y = _bf(rng.randn(48, 128) * 3 + 1), _bf(rng.randn(48, 128))
    gam = jnp.asarray(rng.randn(128) * 0.5 + 1, jnp.float32)
    bet = jnp.asarray(rng.randn(128) * 0.1, jnp.float32)
    dy = _bf(rng.randn(48, 128))
    out, vjp = jax.vjp(pk.fused_layer_norm, x, gam, bet)
    args = [_t(a).requires_grad_() for a in (x, gam, bet)]
    got = ln.fused_layer_norm(*args)[0]
    _close(got, out, 1e-2)
    for g, want, tol in zip(torch.autograd.grad(got, args, _t(dy)), vjp(dy),
                            (1e-2, 1e-5, 1e-5)):
        _close(g, want, tol)

    (s, out), vjp = jax.vjp(pk.fused_add_layer_norm, x, y, gam, bet)
    args = [_t(a).requires_grad_() for a in (x, y, gam, bet)]
    got_s, got, _, _ = aln.fused_add_layer_norm(*args)
    _close(got_s, s, 1e-2)
    _close(got, out, 1e-2)
    for g, want, tol in zip(torch.autograd.grad((got_s, got), args,
                                                (_t(dy), _t(dy))),
                            vjp((dy, dy)), (1e-2, 1e-2, 1e-5, 1e-5)):
        _close(g, want, tol)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_linear_xent_bf16_plain_matches_pallas(eps):
    """bf16 x and w: loss and lse float32 (rtol 1e-5); dx and dw bf16
    with g rounded to bf16 before each product, as _lxent_dx_kernel and
    _lxent_dw_kernel do (rtol 1e-2); labels -1 and V take the smoothing
    term only."""
    rng = np.random.RandomState(2)
    R, H, V = 64, 64, 300
    x, w = _bf(rng.randn(R, H)), _bf(rng.randn(H, V) / 8)
    lab = rng.randint(0, V, R)
    lab[:2] = -1, V
    dy = jnp.asarray(rng.rand(R), jnp.float32)
    loss, lse = pk._lxent_fwd(x, w, jnp.asarray(lab, jnp.int32), eps, 64, 128)
    dx, dw = pk._lxent_bwd(x, w, jnp.asarray(lab, jnp.int32), lse, dy, eps,
                           64, 128)
    lbl = torch.from_numpy(lab.astype(np.int64))
    got_loss, got_lse = lx.linear_xent_plain(_t(x), _t(w), lbl, eps)
    _close(got_loss, loss, 1e-5)
    _close(got_lse, lse, 1e-5)
    got_dx, got_dw = lx.linear_xent_grad_plain(
        _t(x), _t(w), lbl, got_lse, torch.from_numpy(np.array(dy))[:, None],
        eps)
    _close(got_dx, dx, 1e-2)
    _close(got_dw, dw, 1e-2)


# ---------------------------------------------------------------------------
# the kernels' dtype rule and the bf16 forms' dispatch
# ---------------------------------------------------------------------------
def test_kernels_refuse_bf16_without_a_bf16_form():
    """check_inputs takes bf16 for the kernels' bf16 forms (B1 / B2 with
    float32 gamma and beta, B4's dx / dw with float32 lse and dy, B12's
    parts and its dx / dw with float32 row validity, lse and dy; B3 and
    B6: test_torch_amp_attention.py) and refuses it, naming ROADMAP B's
    bf16 forms, for every other kernel (B3's few-row form and B9 among
    them); no form takes a float16 or a bf16 gamma."""
    bf, f32 = torch.bfloat16, torch.float32
    x, v = torch.zeros(4, 8, dtype=bf), torch.zeros(8, dtype=f32)
    build.check_inputs("matmul_bias_act", x, x, v.to(bf))
    build.check_inputs("fused_layer_norm", x, v, v)
    build.check_inputs("fused_add_layer_norm", x, x, v, v)
    build.check_inputs("linear_xent_dx", x, x, v, v)
    build.check_inputs("linear_xent_parts", x, x)
    build.check_inputs("linear_xent_dx_sharded", x, x, v, v, v)
    build.check_inputs("linear_xent_dw_sharded", x, x, v, v, v)
    with pytest.raises(build.KernelTypeError, match="operand 4"):
        build.check_inputs("linear_xent_dw_sharded", x, x, v, v, v.to(bf))
    for name in ("flash_attention_piece_fwd", "flash_attention_fwd_rows",
                 "softmax_xent_fwd", "fused_lstm", "flash_attention_qvec"):
        with pytest.raises(build.KernelTypeError, match="ROADMAP B"):
            build.check_inputs(name, x, x)
    for name in build.KV_BF16_FORMS:  # a bf16 q: B8q, beside bf16 k or not
        for k in (x, x.float()):
            with pytest.raises(build.KernelTypeError, match="B8q"):
                build.check_inputs(name, x, k, k)
    with pytest.raises(build.KernelTypeError, match="operand 1"):
        build.check_inputs("fused_layer_norm", x, v.to(bf), v)
    with pytest.raises(build.KernelTypeError, match="operand 2"):
        build.check_inputs("matmul_bias_act", x, x, v)
    with pytest.raises(build.KernelTypeError):
        build.check_inputs("matmul_bias_act", x.half(), x.half())


def test_bf16_forms_launch_their_own_entry_points(monkeypatch):
    """A bf16 input to each wrapper reaches its bf16 C entry point with
    the float32 form's plan ints (the tiled plan for B5), counted under
    its bf16 name; no bf16 call reaches a float32 entry point."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: calls.append((name, args)))
    bf = torch.bfloat16
    x = torch.randn(32, 64).to(bf)
    w, b = torch.randn(64, 16).to(bf), torch.randn(16).to(bf)
    g, beta = torch.ones(64), torch.zeros(64)
    lbl = torch.zeros(32, dtype=torch.int64)
    lse, dy = torch.zeros(32, 1), torch.ones(32, 1)
    wv = torch.randn(64, 40).to(bf)
    before = {f.__name__: f.launches for f in (
        me.matmul_bias_act_bf16, ln.fused_layer_norm_bf16,
        aln.fused_add_layer_norm_bf16, lx.linear_xent_fwd_bf16,
        lx.linear_xent_dx_bf16, lx.linear_xent_dw_bf16,
        me.matmul_bias_act, lx.linear_xent_fwd)}
    me.matmul_bias_act(x, w, b, "relu")
    ln.fused_layer_norm(x, g, beta)
    aln.fused_add_layer_norm(x, x, g, beta)
    lx.linear_xent_fwd(x, wv, lbl, 0.1)
    lx.linear_xent_dx(x, wv, lbl, lse, dy, 0.1)
    lx.linear_xent_dw(x, wv, lbl, lse, dy, 0.1)
    names = [c[0] for c in calls]
    assert names == ["ptt_matmul_bias_act_bf16", "ptt_layer_norm_bf16",
                     "ptt_add_layer_norm_bf16", "ptt_linear_xent_fwd_bf16",
                     "ptt_linear_xent_dx_bf16", "ptt_linear_xent_dw_bf16"]
    assert list(calls[0][1][-5:]) == list(me.mm_plan(32, 16, 64, bf16=True))
    assert me.mm_plan(4, 2048, 512, bf16=True).form == me.TILED
    assert me.mm_plan(4, 2048, 512).form == me.SKINNY
    # the bf16 forms count apart; the float32 counters did not move
    after = {f.__name__: f.launches for f in (
        me.matmul_bias_act_bf16, ln.fused_layer_norm_bf16,
        aln.fused_add_layer_norm_bf16, lx.linear_xent_fwd_bf16,
        lx.linear_xent_dx_bf16, lx.linear_xent_dw_bf16,
        me.matmul_bias_act, lx.linear_xent_fwd)}
    assert {k: after[k] - before[k] for k in after} == {
        "matmul_bias_act_bf16": 1, "fused_layer_norm_bf16": 1,
        "fused_add_layer_norm_bf16": 1, "linear_xent_fwd_bf16": 1,
        "linear_xent_dx_bf16": 1, "linear_xent_dw_bf16": 1,
        "matmul_bias_act": 0, "linear_xent_fwd": 0}
    # a bf16 input to a kernel without a bf16 form raises, no launch
    from paddle_tpu_torch.kernels import flash_attention_piece_fwd

    with pytest.raises(build.KernelTypeError, match="ROADMAP B"):
        flash_attention_piece_fwd(x[None], x[None], x[None])
    assert len(calls) == 6


# ---------------------------------------------------------------------------
# bf16 training against the reference
# ---------------------------------------------------------------------------
def _held(r_losses, losses, init, r_final, scope):
    """Losses at rtol 5e-3; every persistable float32 and its change from
    `init` within a relative L2 distance of 0.6 of the reference's."""
    np.testing.assert_allclose(losses, r_losses, rtol=5e-3)
    assert len(set(losses)) == len(losses)  # the parameters moved
    moved = 0
    for name, want in r_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if want.dtype != np.float32:
            continue
        d_want = want.astype(np.float64) - init[name]
        d_got = got.astype(np.float64) - init[name]
        norm = np.linalg.norm(d_want)
        if norm == 0:
            assert np.linalg.norm(d_got) == 0, name
            continue
        assert np.linalg.norm(d_got - d_want) <= 0.6 * norm, (
            name, np.linalg.norm(d_got - d_want) / norm)
        moved += 1
    assert moved > len(r_final) // 2


def _with_pallas(fn):
    """fn() under the reference's use_pallas (its kernels in interpret
    mode: the port implements the kernels' bf16 semantics, which its
    dense fc path does not share)."""
    old = {k: ref_flags.get_flag(k) for k in ("use_pallas", "kernel_autotune")}
    ref_flags.set_flags({"use_pallas": True, "kernel_autotune": False})
    try:
        return fn()
    finally:
        ref_flags.set_flags(old)


@pytest.mark.parametrize("fused_attn", [False, True])
def test_wmt_bf16_training_matches_reference(fused_attn):
    """Three Adam steps of the tiny WMT program with use_bf16 (dropout
    0), from the reference's startup arrays carried over as numpy."""
    hp = dict(dropout=0.0, fused_attn=fused_attn, n_layer=1)
    batch = ref_tfm.make_fake_batch(BATCH, SRC, TRG,
                                    _tiny_wmt(ref_tfm.ModelHyperParams), seed=1)

    def reference():
        main, start, _, fetch = ref_tfm.wmt_transformer_program(
            _tiny_wmt(ref_tfm.ModelHyperParams, **hp), src_len=SRC,
            trg_len=TRG, learning_rate=0.005, warmup_steps=2, use_bf16=True)
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
    main, _, _, fetch = port_tfm.wmt_transformer_program(
        _tiny_wmt(port_tfm.ModelHyperParams, **hp), src_len=SRC, trg_len=TRG,
        learning_rate=0.005, warmup_steps=2, use_bf16=True)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        losses = [float(exe.run(main, feed=batch, fetch_list=[fetch[0]])[0]
                        .sum()) for _ in range(3)]
    _held(r_losses, losses, init, r_final, scope)
    assert all(scope.find_var(n).dtype == torch.float32
               for n in r_final if n != "@LR_DECAY_COUNTER@")


def _cifar_bf16(pkg, nhwc):
    net = _nets(pkg)["resnet_cifar10_8"][0]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("image", shape=[3, 32, 32])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        avg = pkg.layers.mean(pkg.layers.cross_entropy(net(img, 10), label))
        if nhwc:
            _mod(pkg, "transpiler.layout_transpiler").rewrite_nhwc(main)
        _mod(pkg, "transpiler.pass_registry").apply_pass(main, "bf16_amp_pass")
        _mod(pkg, "optimizer").Momentum(learning_rate=0.01,
                                        momentum=0.9).minimize(avg)
    return main, startup, avg


@pytest.mark.parametrize("use_nhwc", [False, True])
def test_resnet_bf16_training_matches_reference(use_nhwc):
    """Three Momentum steps of the CIFAR ResNet under bf16_amp_pass
    (after rewrite_nhwc), bf16 convs and batch norms with float32
    statistics, from the reference's startup arrays."""
    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(4, 3, 32, 32).astype("float32"),
             "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    main, start, avg = _cifar_bf16(fluid, use_nhwc)
    names = [n for n, v in main.global_block().vars.items() if v.persistable]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(start)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        r_losses = [float(np.asarray(exe.run(
            main, feed=batch, fetch_list=[avg])[0]).sum()) for _ in range(3)]
        r_final = {n: np.asarray(scope.find_var(n)) for n in names}
    main, _, avg = _cifar_bf16(ptt, use_nhwc)
    types = [o.type for o in main.global_block().ops]
    assert types.count("cast") > 0 and "batch_norm" in types
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    params_from_numpy(init, scope, ptt.CPUPlace())
    losses = [float(exe.run(main, feed=batch, fetch_list=[avg],
                            scope=scope)[0].sum()) for _ in range(3)]
    _held(r_losses, losses, init, r_final, scope)
