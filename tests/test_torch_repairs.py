"""Small agreements with the reference on the CPU:

- every training program that meets `hp.recompute` (per-layer
  rematerialization, not ported yet) raises naming ROADMAP A9, the
  item that holds remat;
- `executor.as_numpy` takes its argument as `value` in both packages, so
  a keyword call works in either and gives equal numpy;
- a test-mode program (clone(for_test=True)) runs none of its training
  ops, as in the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import executor as ref_executor
from paddle_tpu_torch import executor, framework, unique_name
from paddle_tpu_torch.models import bert, gpt2, transformer


@pytest.fixture(autouse=True)
def fresh_programs():
    old_main = framework.switch_main_program(framework.Program())
    old_startup = framework.switch_startup_program(framework.Program())
    old_gen = unique_name.switch()
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)


def _recompute(base, **narrow):
    return type("Remat", (base,), dict(narrow, recompute=True))


@pytest.mark.parametrize("build", [
    lambda: gpt2.gpt2_lm_program(
        _recompute(gpt2.GPT2Config, vocab_size=61, n_ctx=16, d_model=32,
                   n_layer=1, n_head=2), seq_len=8),
    lambda: bert.bert_pretrain_program(
        _recompute(bert.BertConfig, vocab_size=61, max_position=16,
                   d_model=32, d_inner_hid=64, n_layer=1, n_head=2),
        seq_len=8),
    lambda: transformer.wmt_transformer_program(
        _recompute(transformer.ModelHyperParams, src_vocab_size=61,
                   trg_vocab_size=61, max_length=16, d_model=32,
                   d_inner_hid=64, n_layer=1, n_head=2), 8, 8),
], ids=["gpt2", "bert", "transformer"])
def test_recompute_raise_names_roadmap_a9(build):
    with pytest.raises(NotImplementedError, match=r"\(ROADMAP A9\)"):
        build()


@pytest.mark.parametrize("kind", ["tensor", "list"])
def test_as_numpy_takes_value_by_keyword_in_both_packages(kind):
    data = np.arange(12, dtype="float32").reshape(3, 4)
    if kind == "tensor":
        ours = executor.as_numpy(value=torch.tensor(data))
        ref = ref_executor.as_numpy(value=jnp.asarray(data))
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    else:
        ours = executor.as_numpy(value=[torch.tensor(data),
                                        torch.tensor(data[0])])
        ref = ref_executor.as_numpy(value=[jnp.asarray(data),
                                           jnp.asarray(data[0])])
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_test_mode_clone_runs_no_training_op():
    """A clone(for_test=True) of a trained program fetches its prediction
    without the label and steps no optimizer: the executor's dead-code
    walk skips the backward, optimize and lr-schedule ops of a test-mode
    program, as the reference's does (paddle_tpu/core/trace.py
    dce_mask)."""
    import importlib

    import paddle_tpu as fluid
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.io import params_from_numpy

    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = L.data("x", shape=[6])
            label = L.data("label", shape=[1], dtype="int64")
            pred = L.fc(L.dropout(L.fc(x, 8, act="relu"), 0.3), 3,
                        act="softmax")
            loss = L.mean(L.cross_entropy(pred, label))
            importlib.import_module(pkg.__name__ + ".optimizer").SGD(
                0.5).minimize(loss)
        return main, startup, pred

    with fluid.unique_name.guard():
        r_main, r_start, r_pred = build(fluid)
    p_main, _, p_pred = build(ptt)
    r_scope = fluid.Scope()
    x = np.random.RandomState(0).rand(4, 6).astype("float32")
    with fluid.scope_guard(r_scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(r_start)
        names = [n for n, v in r_main.global_block().vars.items()
                 if v.persistable and r_scope.find_var(n) is not None]
        before = {n: np.asarray(r_scope.find_var(n)) for n in names}
        (want,) = exe.run(r_main.clone(for_test=True), feed={"x": x},
                          fetch_list=[r_pred])
    scope = ptt.Scope()
    params_from_numpy(before, scope, ptt.CPUPlace())
    (got,) = ptt.Executor(ptt.CPUPlace()).run(
        p_main.clone(for_test=True), feed={"x": x}, fetch_list=[p_pred],
        scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    for n in names:  # no parameter stepped
        assert np.array_equal(scope.find_var(n).numpy(), before[n]), n
