"""The port's GPT-2 training slice on the CPU: ``gpt2_lm_program``
(forward with dropout, the linear-xent and matmul-epilogue fuse passes,
backward, Adam) built by paddle_tpu_torch against the reference's, op
for op, tied and untied; trained from the reference's startup state
against the reference's losses and updated parameters; dropout masks of
the grad ops against their forward ops'; and the layer_norm and
fused_attention forms this slice puts on kernels.

Tolerances, as in test_torch_training.py: losses rtol 1e-5; parameters
and Adam moments within 1e-4 of each tensor's largest magnitude (Adam
divides by sqrt(moment2) + eps, so a near-zero gradient turns float32
summation-order noise into an update of up to lr)."""

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
from paddle_tpu_torch.parallel.mesh import Mesh

from test_torch_program import _assert_same_program

SEQ, BATCH = 16, 4


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
    attrs = dict(vocab_size=61, n_ctx=32, d_model=64, n_layer=2, n_head=4,
                 dropout=0.1)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


@pytest.mark.parametrize("tied", [False, True])
def test_gpt2_lm_program_and_startup_match_reference(tied):
    """Dropout 0.1, so the dropout ops and their grads are in the
    sequence; the 36 op types of the GPT-2 step, every fused count."""
    r_main, r_start, r_feeds, r_fetch = ref_gpt2.gpt2_lm_program(
        _tiny(ref_gpt2.GPT2Config, tie_embeddings=tied), seq_len=SEQ)
    p_main, p_start, p_feeds, p_fetch = port_gpt2.gpt2_lm_program(
        _tiny(port_gpt2.GPT2Config, tie_embeddings=tied), seq_len=SEQ)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    assert p_feeds == r_feeds == ["ids", "labels", "loss_weight"]
    assert [v.name for v in p_fetch] == [v.name for v in r_fetch]
    types = [o.type for o in p_main.global_block().ops]
    assert len(set(types)) == 36
    assert types.count("layer_norm") == 1  # the one no residual add precedes
    assert types.count("fused_attention") == 2
    assert types.count("fused_residual_ln") == 2 * 2
    assert types.count("dropout") == types.count("dropout_grad") == 1 + 2 * 2
    assert types.count("clip") == 1 and "softmax_with_cross_entropy" not in types
    for count in ("_linear_xent_fused_count", "_fc_fused_count",
                  "_residual_ln_fused_count", "_matmul_epilogue_fused_count"):
        assert getattr(p_main, count) == getattr(r_main, count), count
    assert p_main._linear_xent_fused_count == 1
    xent = next(o for o in p_main.global_block().ops
                if o.type == "fused_linear_xent")
    assert xent.attrs["transpose_w"] == tied
    assert types.count("adam") == len([
        p for p in p_main.global_block().all_parameters() if p.trainable])


def _train_reference(hp, steps, batch):
    main, start, _, fetch = ref_gpt2.gpt2_lm_program(hp, seq_len=SEQ, lr=3e-3)
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


@pytest.mark.parametrize("tied", [False, True])
def test_gpt2_training_matches_reference_over_adam_steps(tied):
    """Dropout 0, five Adam steps from the reference's startup arrays,
    carried over as numpy."""
    batch = ref_gpt2.make_fake_lm_batch(
        BATCH, SEQ, _tiny(ref_gpt2.GPT2Config), seed=1)
    batch["loss_weight"][1, SEQ // 2:] = 0.0  # some pad tokens
    init, r_losses, r_final = _train_reference(
        _tiny(ref_gpt2.GPT2Config, dropout=0.0, tie_embeddings=tied), 5,
        batch)
    main, _, _, fetch = port_gpt2.gpt2_lm_program(
        _tiny(port_gpt2.GPT2Config, dropout=0.0, tie_embeddings=tied),
        seq_len=SEQ, lr=3e-3)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        out = [exe.run(main, feed=batch, fetch_list=fetch) for _ in range(5)]
    losses = [float(loss.sum()) for loss, _ in out]
    assert all(float(tok.sum()) == batch["loss_weight"].sum() for _, tok in out)
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


def test_gpt2_dropout_grads_use_the_forward_masks():
    """Dropout 0.1 on the port alone: each dropout_grad's X@GRAD is its
    Out@GRAD times the Mask its forward op drew, and a seeded run repeats
    bit for bit."""
    hp = _tiny(port_gpt2.GPT2Config)
    main, start, _, fetch = port_gpt2.gpt2_lm_program(hp, seq_len=SEQ)
    block = main.global_block()
    grads = [op for op in block.ops if op.type == "dropout_grad"]
    assert len(grads) == 1 + 2 * hp.n_layer
    names = []
    for g in grads:
        f = block.ops[g.attrs["__fwd_op_idx__"]]
        assert f.type == "dropout"
        names += [f.outputs["Mask"][0], g.inputs["Out@GRAD"][0],
                  g.outputs["X@GRAD"][0]]
    start.random_seed = main.random_seed = 3
    batch = port_gpt2.make_fake_lm_batch(BATCH, SEQ, hp, seed=2)

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


def test_make_fake_lm_batch_matches_reference():
    hp = _tiny(port_gpt2.GPT2Config)
    got = port_gpt2.make_fake_lm_batch(3, 7, hp, seed=4)
    want = ref_gpt2.make_fake_lm_batch(3, 7, _tiny(ref_gpt2.GPT2Config),
                                       seed=4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("option,item", [
    ({"use_bf16": True}, "A3"),
    ({"mesh": Mesh(("dp", "mp"), (1, 2), (0, 0), {})}, "A7"),
    ({"hp_recompute": True}, "A9")])
def test_gpt2_lm_program_unported_options_raise(option, item):
    hp = _tiny(port_gpt2.GPT2Config,
               recompute=option.pop("hp_recompute", False))
    with pytest.raises(NotImplementedError, match=item):
        main, startup, _, fetch = port_gpt2.gpt2_lm_program(hp, seq_len=SEQ, **option)
        # a mesh stamps the program with the family's rules, and the
        # executor refuses their trunk entries at mp 2 before any step
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=port_gpt2.make_fake_lm_batch(BATCH, SEQ, hp), fetch_list=fetch[:1])


def test_gpt2_step_reaches_the_new_kernel_wrappers(monkeypatch):
    """One training step of the tiny config on the CPU calls the
    layer-norm and flash-attention wrappers through the op lowerings:
    every kernel of the GPT-2 path sits under an op of the program (dq
    and dk/dv under the backward's dispatch, ``_flash_grad``)."""
    from paddle_tpu_torch.kernels import build

    seen = set()
    real = build.use_kernel

    def spy(t):
        seen.add(sys._getframe(1).f_code.co_name)  # the wrapper asking
        return real(t)

    monkeypatch.setattr(build, "use_kernel", spy)
    hp = _tiny(port_gpt2.GPT2Config)
    main, start, _, fetch = port_gpt2.gpt2_lm_program(hp, seq_len=SEQ)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    exe.run(main, feed=port_gpt2.make_fake_lm_batch(2, SEQ, hp),
            fetch_list=fetch)
    assert {"_ln_forward", "flash_attention_fwd", "_flash_grad",
            "_add_ln_forward", "_mm_forward", "linear_xent_fwd"} <= seen, seen
