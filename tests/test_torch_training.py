"""The port's training slice on the CPU: the WMT Transformer's training
program (forward, fuse passes, backward, noam lr, Adam) built by
paddle_tpu_torch against the reference's, op for op, and trained from
the reference's startup state against the reference's losses and
updated parameters; dropout masks of the grad ops against their forward
ops'; and a seeded run that repeats bit for bit.

Tolerances: losses rtol 1e-5.  Parameters and Adam moments: max abs
difference within 1e-4 of the tensor's largest magnitude — Adam divides
by sqrt(moment2) + 1e-9, so an element whose gradient is near zero turns
float32 summation-order noise into an update of up to lr, and an
elementwise rtol would measure that noise, not the port."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import transformer as ref_tfm
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import transformer as port_tfm

from test_torch_program import _assert_same_program

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


def _tiny(base, **kw):
    attrs = dict(src_vocab_size=53, trg_vocab_size=61, max_length=16,
                 d_model=32, d_inner_hid=64, n_head=4, n_layer=2, dropout=0.1)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


def test_wmt_program_and_startup_match_reference():
    """Dropout 0.1, so dropout and its grads are in the sequence; grad,
    sum, lr-schedule and adam ops included."""
    r_main, r_start, r_feeds, r_fetch = ref_tfm.wmt_transformer_program(
        _tiny(ref_tfm.ModelHyperParams), src_len=SRC, trg_len=TRG)
    p_main, p_start, p_feeds, p_fetch = port_tfm.wmt_transformer_program(
        _tiny(port_tfm.ModelHyperParams), src_len=SRC, trg_len=TRG)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    assert p_feeds == r_feeds
    assert [v.name for v in p_fetch] == [v.name for v in r_fetch]
    types = [o.type for o in p_main.global_block().ops]
    assert len(set(types)) == 39
    assert "layer_norm" not in types and "one_hot" not in types
    assert types.count("fused_linear_xent") == 1
    assert types.count("fused_residual_ln") == 3 * 2 + 2 * 2
    assert types.count("dropout") == types.count("dropout_grad") > 0
    assert p_main._smooth_xent_fused_count == 1
    assert p_main._linear_xent_fused_count == 1
    assert types.count("adam") == len([
        p for p in p_main.global_block().all_parameters() if p.trainable])


def test_wmt_fused_attn_program_matches_reference():
    """hp.fused_attn: every attention is fused_attention (causal with the
    target key bias in the decoder's self attention, the source key bias
    elsewhere) and the dense masks reach it as rank-1 key biases."""
    r_main, r_start, _, _ = ref_tfm.wmt_transformer_program(
        _tiny(ref_tfm.ModelHyperParams, fused_attn=True), src_len=SRC,
        trg_len=TRG)
    p_main, p_start, _, _ = port_tfm.wmt_transformer_program(
        _tiny(port_tfm.ModelHyperParams, fused_attn=True), src_len=SRC,
        trg_len=TRG)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    ops = p_main.global_block().ops
    types = [o.type for o in ops]
    assert "softmax" not in types and "matmul" not in types
    fused = [o for o in ops if o.type == "fused_attention"]
    assert len(fused) == 3 * 2  # encoder self; decoder self and cross
    assert types.count("fused_attention_grad") == len(fused)
    assert sum(o.attrs["causal"] for o in fused) == 2
    assert all(o.inputs.get("Bias") for o in fused)


def _train_reference(hp, lr, steps, batch):
    main, start, _, fetch = ref_tfm.wmt_transformer_program(
        hp, src_len=SRC, trg_len=TRG, learning_rate=lr, warmup_steps=2)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(start)
        names = [n for n, v in start.global_block().vars.items()
                 if v.persistable]
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        losses = [float(np.asarray(exe.run(main, feed=batch,
                                           fetch_list=[fetch[0]])[0]).sum())
                  for _ in range(steps)]
        final = {n: np.asarray(scope.find_var(n)) for n in names}
    return init, losses, final


def test_wmt_training_matches_reference_over_adam_steps():
    """Dropout 0, five Adam steps (noam warmup 2, so the parameters
    move) from the reference's startup arrays, carried over as numpy."""
    _train_against_reference(fused_attn=False)


def test_wmt_fused_attn_training_matches_reference_over_adam_steps():
    """The same with hp.fused_attn: flash attention's causal and key-bias
    forms in place of the batched matmul / softmax attention."""
    _train_against_reference(fused_attn=True)


def _train_against_reference(fused_attn):
    batch = ref_tfm.make_fake_batch(BATCH, SRC, TRG,
                                    _tiny(ref_tfm.ModelHyperParams), seed=1)
    init, r_losses, r_final = _train_reference(
        _tiny(ref_tfm.ModelHyperParams, dropout=0.0, fused_attn=fused_attn),
        0.005, 5, batch)
    main, start, _, fetch = port_tfm.wmt_transformer_program(
        _tiny(port_tfm.ModelHyperParams, dropout=0.0, fused_attn=fused_attn),
        src_len=SRC, trg_len=TRG, learning_rate=0.005, warmup_steps=2)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        losses = [float(exe.run(main, feed=batch, fetch_list=[fetch[0]])[0]
                        .sum()) for _ in range(5)]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    assert len(set(losses)) == 5  # the parameters moved every step
    assert float(scope.find_var("@LR_DECAY_COUNTER@")) == 6.0
    moved = 0
    for name, want in r_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name
        moved += not np.array_equal(want, init[name])
    assert moved > len(r_final) // 2


def _port_train(hp, steps, fetch_extra=()):
    main, start, _, fetch = port_tfm.wmt_transformer_program(
        hp, src_len=SRC, trg_len=TRG)
    start.random_seed = main.random_seed = 3
    batch = port_tfm.make_fake_batch(BATCH, SRC, TRG, hp, seed=2)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    out = []
    with ptt.scope_guard(scope):
        exe.run(start)
        for _ in range(steps):
            out.append(exe.run(main, feed=batch,
                               fetch_list=[fetch[0]] + list(fetch_extra)))
    return main, out


def test_dropout_grads_use_the_forward_masks_and_runs_repeat():
    """Dropout 0.1 on the port alone: each dropout_grad's X@GRAD is its
    Out@GRAD times the Mask its forward op drew (the grad op re-runs the
    rule under the forward op's index), and the same seeds give the same
    losses twice."""
    hp = _tiny(port_tfm.ModelHyperParams)
    main, _, _, _ = port_tfm.wmt_transformer_program(hp, src_len=SRC,
                                                     trg_len=TRG)
    block = main.global_block()
    grads = [op for op in block.ops if op.type == "dropout_grad"]
    fwd = {id(op): op for op in block.ops if op.type == "dropout"}
    assert grads and len(fwd) == len(grads)
    names = []
    for g in grads:
        f = block.ops[g.attrs["__fwd_op_idx__"]]
        assert id(f) in fwd
        names += [f.outputs["Mask"][0], g.inputs["Out@GRAD"][0],
                  g.outputs["X@GRAD"][0]]
    _, run = _port_train(hp, 2, names)
    for step in run:
        vals = step[1:]
        for i in range(0, len(vals), 3):
            mask, dout, dx = vals[i:i + 3]
            assert 0.0 < mask.mean() < 1.0
            np.testing.assert_array_equal(dx, dout * mask)
    _, again = _port_train(hp, 2, names)
    assert [r[0].tolist() for r in run] == [r[0].tolist() for r in again]
    assert run[0][0].tolist() != run[1][0].tolist()


def test_grad_of_an_op_that_overwrites_its_input():
    """y = x * 2, then y = y * w in place (the op's Out names its input),
    loss = sum(y * y).  backward.py hands the in-place op the grad of the
    var after it, and the runner re-runs the op's forward on its inputs
    as they were before it ran (the snapshot), so dL/dw = sum(2 y^2 w)
    over the pre-op y, and dL/dx = 2 * 2 y w^2."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.backward import append_backward

    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = layers.data("x", shape=[3], append_batch_size=False)
        x.stop_gradient = False
        w = layers.create_parameter([3], "float32", name="w")
        y = layers.scale(x, scale=2.0)
        block = main.global_block()
        block.append_op("elementwise_mul", inputs={"X": [y], "Y": [w]},
                        outputs={"Out": [y]}, attrs={"axis": -1})
        loss = layers.reduce_sum(layers.elementwise_mul(y, y))
        params_grads = append_backward(loss)
    (_, gw), = params_grads
    gx = main._grad_names["x"]
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    xv = np.array([1.0, -2.0, 0.5], "float32")
    wv = np.array([0.5, 3.0, -1.0], "float32")
    with ptt.scope_guard(scope):
        params_from_numpy({"w": wv}, scope, ptt.CPUPlace())
        got_w, got_x = exe.run(main, feed={"x": xv}, fetch_list=[gw, gx])
    y0 = 2 * xv
    np.testing.assert_allclose(got_w, 2 * y0 * y0 * wv, rtol=1e-6)
    np.testing.assert_allclose(got_x, 2 * 2 * y0 * wv * wv, rtol=1e-6)
