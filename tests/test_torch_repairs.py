"""Two small agreements with the reference on the CPU:

- every training program that meets `hp.recompute` (per-layer
  rematerialization, not ported yet) raises naming ROADMAP A9, the
  item that holds remat;
- `executor.as_numpy` takes its argument as `value` in both packages, so
  a keyword call works in either and gives equal numpy."""

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
