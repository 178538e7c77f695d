"""The port's BERT pretraining slice on the CPU: ``bert_pretrain_program``
(MLM + NSP, the linear-xent and matmul-epilogue fuse passes, backward,
Adam) built by paddle_tpu_torch against the reference's, op for op, in
training and with ``is_test``, with ``fused_attn`` on and off; the
weights carried over from the reference's startup by name; five Adam
steps against the reference's three losses and updated parameters; and
the kernels this slice puts on the path (the softmax cross-entropy
kernels under the NSP head, flash attention's key-bias form).

Tolerances: losses rtol 1e-5, as in test_torch_training.py.  Parameters
and Adam moments: within 1e-4 of each tensor's largest magnitude or 1e-2
of the learning rate, whichever is larger.  Adam divides by
sqrt(moment2) + eps, so an element whose first gradient is near zero
(pooler.w has some at 2e-7) turns float32 summation-order noise into an
update of up to lr, and BERT's small tables (std 0.02) make 1e-4 of
their magnitude smaller than that noise (measured: 1.8e-5 at lr 3e-3
on pooler.w with the unfused attention, where the step-1 gradients
agree to 5e-7 of their largest)."""

import sys

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import bert as ref_bert
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.parallel.mesh import Mesh

from test_torch_program import _assert_same_program

SEQ, BATCH, LR = 16, 4, 3e-3


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
    attrs = dict(vocab_size=61, max_position=32, d_model=64, d_inner_hid=128,
                 n_head=4, n_layer=2, dropout=0.1, fused_attn=True)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


def _ref_program(hp, **kw):
    """The reference builds under the current name generator, as the
    port does: a fresh one gives both the same names."""
    with fluid.unique_name.guard():
        return ref_bert.bert_pretrain_program(hp, seq_len=SEQ, **kw)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("is_test", [False, True])
def test_bert_program_and_startup_match_reference(fused, is_test):
    """Dropout 0.1, so the dropout ops (and in training their grads) are
    in the sequence; grad, sum and adam ops included; the fused counts."""
    r_main, r_start, r_feeds, r_fetch = _ref_program(
        _tiny(ref_bert.BertConfig, fused_attn=fused), is_test=is_test)
    p_main, p_start, p_feeds, p_fetch = port_bert.bert_pretrain_program(
        _tiny(port_bert.BertConfig, fused_attn=fused), seq_len=SEQ,
        is_test=is_test)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    assert p_feeds == r_feeds
    assert [v.name for v in p_fetch] == [v.name for v in r_fetch]
    types = [o.type for o in p_main.global_block().ops]
    assert types.count("fused_attention") == (2 if fused else 0)
    assert types.count("layer_norm") == 2  # embeddings and the MLM head
    assert types.count("fused_residual_ln") == 2 * 2
    assert types.count("fused_linear_xent") == 1
    assert types.count("softmax_with_cross_entropy") == 1  # the NSP head
    assert types.count("fc") == 2 * 2 + 3  # FFN, mlm_trans, pooler, nsp
    for count in ("_linear_xent_fused_count", "_fc_fused_count",
                  "_residual_ln_fused_count", "_matmul_epilogue_fused_count"):
        assert getattr(p_main, count) == getattr(r_main, count), count
    if fused and not is_test:
        assert len(set(types)) == 43
    if not is_test:
        assert types.count("adam") == len([
            p for p in p_main.global_block().all_parameters() if p.trainable])
    else:
        assert "adam" not in types


def _ref_init(hp):
    main, start, _, fetch = _ref_program(hp, lr=LR)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(start)
        names = [n for n, v in start.global_block().vars.items()
                 if v.persistable]
        init = {n: np.asarray(scope.find_var(n)) for n in names}
    return main, fetch, scope, exe, init


def test_bert_weights_carry_over_from_the_reference():
    """The reference's startup arrays land in the port's scope by name,
    unchanged, and the port's test program computes the reference's three
    losses from them (rtol 1e-5)."""
    hp_r = _tiny(ref_bert.BertConfig, dropout=0.0)
    r_main, r_start, _, r_fetch = _ref_program(hp_r, is_test=True)
    batch = ref_bert.make_fake_bert_batch(BATCH, SEQ, hp_r, seed=2)
    r_exe = fluid.Executor(fluid.CPUPlace())
    r_scope = fluid.Scope()
    with fluid.scope_guard(r_scope):
        r_exe.run(r_start)
        init = {n: np.asarray(r_scope.find_var(n))
                for n, v in r_start.global_block().vars.items()
                if v.persistable}
        want = r_exe.run(r_main, feed=batch, fetch_list=r_fetch)
    p_main, p_start, _, p_fetch = port_bert.bert_pretrain_program(
        _tiny(port_bert.BertConfig, dropout=0.0), seq_len=SEQ, is_test=True)
    names = [n for n, v in p_start.global_block().vars.items()
             if v.persistable]
    assert sorted(names) == sorted(init)
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        for n in names:
            np.testing.assert_array_equal(scope.find_var(n).numpy(), init[n])
        got = ptt.Executor(ptt.CPUPlace()).run(p_main, feed=batch,
                                               fetch_list=p_fetch)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_bert_training_matches_reference_over_adam_steps(fused):
    """Dropout 0, five Adam steps from the reference's startup arrays,
    carried over as numpy: total, MLM and NSP losses at rtol 1e-5, and
    every updated parameter and moment."""
    hp_r = _tiny(ref_bert.BertConfig, dropout=0.0, fused_attn=fused)
    r_main, r_fetch, r_scope, r_exe, init = _ref_init(hp_r)
    batch = ref_bert.make_fake_bert_batch(BATCH, SEQ, hp_r, seed=1)
    with fluid.scope_guard(r_scope):
        r_losses = [[float(np.asarray(v).sum()) for v in
                     r_exe.run(r_main, feed=batch, fetch_list=r_fetch)]
                    for _ in range(5)]
        r_final = {n: np.asarray(r_scope.find_var(n)) for n in init}
    main, _, _, fetch = port_bert.bert_pretrain_program(
        _tiny(port_bert.BertConfig, dropout=0.0, fused_attn=fused),
        seq_len=SEQ, lr=LR)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        losses = [[float(v.sum()) for v in exe.run(main, feed=batch,
                                                    fetch_list=fetch)]
                  for _ in range(5)]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    assert len({step[0] for step in losses}) == 5  # it moved every step
    assert abs(losses[0][1] - np.log(61)) < 0.5
    assert abs(losses[0][2] - np.log(2)) < 0.5
    moved = 0
    for name, want in r_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        tol = max(1e-4 * float(np.abs(want).max()), 1e-2 * LR)
        assert float(np.abs(got - want).max()) <= tol, name
        moved += not np.array_equal(want, init[name])
    assert moved > len(r_final) // 2


def test_bert_dropout_grads_use_the_forward_masks():
    """Dropout 0.1 on the port alone: each dropout_grad's X@GRAD is its
    Out@GRAD times the Mask its forward op drew, and a seeded run repeats
    bit for bit."""
    hp = _tiny(port_bert.BertConfig)
    main, start, _, fetch = port_bert.bert_pretrain_program(hp, seq_len=SEQ)
    block = main.global_block()
    grads = [op for op in block.ops if op.type == "dropout_grad"]
    # the embeddings; per layer the attention output, the FFN hidden
    # layer and the FFN output (fused attention drops no probabilities)
    assert len(grads) == 1 + 3 * hp.n_layer
    names = []
    for g in grads:
        f = block.ops[g.attrs["__fwd_op_idx__"]]
        assert f.type == "dropout"
        names += [f.outputs["Mask"][0], g.inputs["Out@GRAD"][0],
                  g.outputs["X@GRAD"][0]]
    start.random_seed = main.random_seed = 3
    batch = port_bert.make_fake_bert_batch(BATCH, SEQ, hp, seed=2)

    def train():
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        with ptt.scope_guard(scope):
            exe.run(start)
            return [exe.run(main, feed=batch, fetch_list=[fetch[0]] + names)
                    for _ in range(2)]

    run = train()
    for step in run:
        vals = step[1:]
        for i in range(0, len(vals), 3):
            mask, dout, dx = vals[i:i + 3]
            assert 0.0 < mask.mean() < 1.0
            np.testing.assert_array_equal(dx, dout * mask)
    again = train()
    assert [r[0].tolist() for r in run] == [r[0].tolist() for r in again]
    assert run[0][0].tolist() != run[1][0].tolist()


def test_make_fake_bert_batch_matches_reference():
    hp = _tiny(port_bert.BertConfig)
    got = port_bert.make_fake_bert_batch(3, 9, hp, seed=4)
    want = ref_bert.make_fake_bert_batch(3, 9, _tiny(ref_bert.BertConfig),
                                         seed=4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_bert_config_is_bert_base():
    """The defaults are BERT-base's published widths (google-research/bert
    uncased_L-12_H-768_A-12), as the reference's."""
    for attr in ("vocab_size", "type_vocab_size", "max_position", "d_model",
                 "d_inner_hid", "n_head", "n_layer", "dropout", "fused_attn"):
        assert getattr(port_bert.BertConfig, attr) == getattr(
            ref_bert.BertConfig, attr), attr
    assert (port_bert.BertConfig.vocab_size, port_bert.BertConfig.d_model,
            port_bert.BertConfig.n_layer) == (30522, 768, 12)


@pytest.mark.parametrize("option,item", [
    ({"mesh": Mesh(("dp", "mp"), (1, 2), (0, 0), {})}, "A7"),
    ({"hp_recompute": True}, "A9")])
def test_bert_pretrain_program_unported_options_raise(option, item):
    hp = _tiny(port_bert.BertConfig,
               recompute=option.pop("hp_recompute", False))
    with pytest.raises(NotImplementedError, match=item):
        main, startup, _, fetch = port_bert.bert_pretrain_program(hp, seq_len=SEQ, **option)
        # a mesh stamps the program with the family's rules, and the
        # executor refuses their trunk entries at mp 2 before any step
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=port_bert.make_fake_bert_batch(BATCH, SEQ, hp), fetch_list=fetch[:1])


def test_bert_step_reaches_the_kernel_wrappers(monkeypatch):
    """One training step of the tiny config on the CPU calls every kernel
    wrapper of the BERT path through the op lowerings: the softmax
    cross-entropy forward and backward under the NSP head, flash
    attention's key-bias form, layer norm, add-LN, matmul_bias_act and
    the linear cross entropy."""
    from paddle_tpu_torch.kernels import build

    seen = set()
    real = build.use_kernel

    def spy(t):
        seen.add(sys._getframe(1).f_code.co_name)  # the wrapper asking
        return real(t)

    monkeypatch.setattr(build, "use_kernel", spy)
    hp = _tiny(port_bert.BertConfig)
    main, start, _, fetch = port_bert.bert_pretrain_program(hp, seq_len=SEQ)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    exe.run(main, feed=port_bert.make_fake_bert_batch(2, SEQ, hp),
            fetch_list=fetch)
    assert {"softmax_xent_fwd", "softmax_xent_bwd", "flash_attention_fwd",
            "_flash_grad", "_ln_forward", "_add_ln_forward", "_mm_forward",
            "linear_xent_fwd"} <= seen, seen
