"""The modern-decoder GPT-2 options through the port on the CPU: a tiny
config with all three (SwiGLU with ffn_multiple_of 8, rotary positions,
grouped-query attention with 2 kv heads for 4 query heads; vocab 61,
n_ctx 32, d_model 64, 2 layers, dropout 0), the shape of TinyLlama's
decoder at a test's size.

- five Adam steps of gpt2_lm_program from the reference's startup state
  against the reference's losses (rtol 1e-5) and updated parameters and
  moments (within 1e-4 of each tensor's largest magnitude, as in
  test_torch_gpt2_training.py);
- the weights carry across by name: the port's startup creates the
  reference's names and shapes (ffn_gate.w / ffn_up.w, the narrowed
  mha_k.w / mha_v.w, no pos_emb.w);
- both serving engines in lockstep on the churn trace of
  test_torch_serving.py: equal feeds, logits at rtol 1e-4, atol 1e-5 at
  every step, the same tokens for every request; and the port's pooled
  run equal to its run_solo bit for bit;
- a training step reaches the matmul_swiglu wrapper (the kernel on the
  card) through fused_swiglu and its grad."""

import sys

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import gpt2 as ref_gpt2
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.serving import Request

from test_torch_gpt2_training import BATCH, SEQ, _train_reference
from test_torch_serving import ENGINE, _assert_same_steps, _churn, _lockstep

_HP = dict(vocab_size=61, n_ctx=32, d_model=64, n_layer=2, n_head=4,
           n_kv_head=2, use_rotary=True, use_swiglu=True, ffn_multiple_of=8,
           dropout=0.0)
RefLlama = type("RefLlama", (ref_gpt2.GPT2Config,), _HP)
PortLlama = type("PortLlama", (port_gpt2.GPT2Config,), _HP)


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


def test_llama_training_matches_reference_over_adam_steps():
    batch = ref_gpt2.make_fake_lm_batch(BATCH, SEQ, RefLlama, seed=1)
    batch["loss_weight"][1, SEQ // 2:] = 0.0  # some pad tokens
    init, r_losses, r_final = _train_reference(RefLlama, 5, batch)
    main, _, _, fetch = port_gpt2.gpt2_lm_program(PortLlama, seq_len=SEQ,
                                                  lr=3e-3)
    assert main._swiglu_fused_count == PortLlama.n_layer
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        out = [exe.run(main, feed=batch, fetch_list=fetch) for _ in range(5)]
    losses = [float(loss.sum()) for loss, _ in out]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    assert len(set(losses)) == 5  # the parameters moved every step
    assert abs(losses[0] - np.log(61)) < 0.5
    moved = 0
    for name, want in r_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name
        moved += not np.array_equal(want, init[name])
    assert moved > len(r_final) // 2


def test_llama_weights_carry_by_name():
    """The reference's startup scope and the port's hold the same names
    and shapes; params_from_numpy carries the reference's arrays into
    the port's scope unchanged."""
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        _, start, _, _ = ref_gpt2.gpt2_logits_program(RefLlama, seq_len=16)
        fluid.Executor(fluid.CPUPlace()).run(start)
        ref_scope = fluid.global_scope()
        ref = {n: np.asarray(ref_scope.find_var(n))
               for n in ref_scope.local_var_names()}
    _, p_start, _, _ = port_gpt2.gpt2_logits_program(PortLlama, seq_len=16)
    own = ptt.Scope()
    with ptt.scope_guard(own):
        ptt.Executor(ptt.CPUPlace()).run(p_start)
    assert {n: tuple(own.find_var(n).shape)
            for n in own.local_var_names()} == {n: a.shape
                                                for n, a in ref.items()}
    assert ref["ffn_gate.w_0"].shape == ref["ffn_up.w_0"].shape == (64, 176)
    assert ref["mha_k.w_0"].shape == ref["mha_v.w_0"].shape == (64, 32)
    assert not any(n.startswith(("pos_emb", "ffn_in")) for n in ref)
    carried = ptt.Scope()
    assert sorted(params_from_numpy(ref, carried, ptt.CPUPlace())) == sorted(
        ref)
    for n, a in ref.items():
        np.testing.assert_array_equal(carried.find_var(n).numpy(), a)


@pytest.fixture(scope="module")
def llama_engines():
    """Both engines through the churn trace, in lockstep, on the tiny
    modern-decoder config."""
    return _lockstep(ENGINE, _churn, RefLlama, PortLlama)


def test_llama_engines_match_reference_every_step(llama_engines):
    _assert_same_steps(llama_engines, 8)
    for rid, r in llama_engines["ref_results"].items():
        p = llama_engines["port_results"][rid]
        assert p["status"] == r["status"] == "OK"
        np.testing.assert_array_equal(p["tokens"], r["tokens"])


def test_llama_port_pooled_equals_run_solo(llama_engines):
    eng = llama_engines["port_eng"]
    with ptt.scope_guard(llama_engines["port_scope"]):
        pooled, stats = eng.run(_churn(Request))
        assert stats["admitted"] == 8 and stats["finished"] == 8
        for req in _churn(Request):
            solo, _ = eng.run_solo(req)
            np.testing.assert_array_equal(pooled[req.rid]["tokens"], solo)
            assert pooled[req.rid]["tokens"].size == req.max_new_tokens


def test_llama_step_reaches_the_swiglu_kernel_wrapper(monkeypatch):
    """One training step calls the matmul_swiglu wrapper through
    fused_swiglu (forward, and again in its grad's re-run), beside the
    kernels of the GPT-2 path."""
    from paddle_tpu_torch.kernels import build

    seen = []
    real = build.use_kernel

    def spy(t):
        if t.device.type != "meta":  # not build-time shape inference
            seen.append(sys._getframe(1).f_code.co_name)  # the wrapper
        return real(t)

    monkeypatch.setattr(build, "use_kernel", spy)
    main, start, _, fetch = port_gpt2.gpt2_lm_program(PortLlama, seq_len=SEQ)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    seen.clear()
    exe.run(main, feed=port_gpt2.make_fake_lm_batch(2, SEQ, PortLlama),
            fetch_list=fetch)
    assert seen.count("_swiglu_forward") == 2 * PortLlama.n_layer
    assert {"_ln_forward", "flash_attention_fwd", "_flash_grad",
            "_add_ln_forward", "_mm_forward", "linear_xent_fwd"} <= set(seen)
