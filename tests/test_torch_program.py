"""paddle_tpu_torch program builders against the reference builders: the
ragged serving step, its slot-reset and cache-startup programs, and the
GPT-2 logits program with its startup have the reference's op sequence
(types, slot names, var names, attrs), parameter names, and every var's
inferred shape and dtype.  Dtypes compare up to the dtype policy:
the reference runs int64 as int32 on the device, the port keeps int64.
Also: the options still to be ported raise, and Executor() with no CUDA
device raises."""

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401
from paddle_tpu.models import decode_cache as ref_dc
from paddle_tpu.models import gpt2 as ref_gpt2
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.models import decode_cache as port_dc
from paddle_tpu_torch.models import gpt2 as port_gpt2


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
                 dropout=0.0)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


def _dtype(d):
    return {"int32": "int64"}.get(d, d)


def _attrs(op):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in op.attrs.items() if k not in ("op_role", "op_role_var")}


def _assert_same_program(ref, port):
    rb, pb = ref.global_block(), port.global_block()
    r_ops = [(o.type, o.inputs, o.outputs, _attrs(o)) for o in rb.ops]
    p_ops = [(o.type, o.inputs, o.outputs, _attrs(o)) for o in pb.ops]
    assert len(p_ops) == len(r_ops)
    for i, (a, b) in enumerate(zip(r_ops, p_ops)):
        assert b == a, "op %d differs:\nref  %s\nport %s" % (i, a, b)
    assert sorted(p.name for p in pb.all_parameters()) == sorted(
        p.name for p in rb.all_parameters())
    assert list(pb.vars) == list(rb.vars)
    for name, rv in rb.vars.items():
        pv = pb.vars[name]
        assert pv.shape == rv.shape, (name, rv.shape, pv.shape)
        assert _dtype(pv.dtype) == _dtype(rv.dtype), (name, rv.dtype, pv.dtype)
        assert pv.persistable == rv.persistable, name


@pytest.mark.parametrize("tied", [False, True])
def test_ragged_step_programs_match_reference(tied):
    kw = dict(batch=4, t_max=24, width=4)
    r_main, r_start, r_feeds, r_fetch, r_names = \
        ref_gpt2.gpt2_ragged_step_program(
            _tiny(ref_gpt2.GPT2Config, tie_embeddings=tied), **kw)
    p_main, p_start, p_feeds, p_fetch, p_names = \
        port_gpt2.gpt2_ragged_step_program(
            _tiny(port_gpt2.GPT2Config, tie_embeddings=tied), **kw)
    _assert_same_program(r_main, p_main)
    _assert_same_program(r_start, p_start)
    assert p_feeds == r_feeds and p_names == r_names
    assert p_fetch[0].name == r_fetch[0].name
    types = {o.type for o in p_main.global_block().ops}
    assert "layer_norm" not in types  # every LN fused with its residual add
    assert {"fc", "fused_residual_ln", "fused_attention",
            "slot_cache_write"} <= types
    if tied:
        assert "matmul" in types
    shapes = [(n, (4, 4, 24, 16)) for n in r_names]
    _assert_same_program(ref_dc.make_slot_reset_program(shapes, 4),
                         port_dc.make_slot_reset_program(shapes, 4))


def test_one_slot_ragged_step_program_matches_reference():
    """A pool of one slot: the same program, with a one-row QStart."""
    kw = dict(batch=1, t_max=16, width=4)
    r_main, _, _, _, _ = ref_gpt2.gpt2_ragged_step_program(
        _tiny(ref_gpt2.GPT2Config), **kw)
    p_main, _, _, _, _ = port_gpt2.gpt2_ragged_step_program(
        _tiny(port_gpt2.GPT2Config), **kw)
    _assert_same_program(r_main, p_main)
    attn = [o for o in p_main.global_block().ops if o.type == "fused_attention"]
    assert len(attn) == 2
    for op in attn:
        qstart = op.inputs["QStart"][0]
        assert p_main.global_block().var(qstart).shape == (1,)


def test_logits_program_and_startup_match_reference():
    r_main, r_start, _, r_fetch = ref_gpt2.gpt2_logits_program(
        _tiny(ref_gpt2.GPT2Config), seq_len=24)
    p_main, p_start, _, p_fetch = port_gpt2.gpt2_logits_program(
        _tiny(port_gpt2.GPT2Config), seq_len=24)
    _assert_same_program(r_main, p_main)
    _assert_same_program(r_start, p_start)
    assert p_fetch[0].shape == (-1, 24, 61)


@pytest.mark.parametrize("option", [{"use_swiglu": True},
                                    {"use_rotary": True},
                                    {"n_kv_head": 2}])
def test_unported_model_options_raise(option):
    hp = _tiny(port_gpt2.GPT2Config, **option)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_gpt2.gpt2_ragged_step_program(hp, batch=2, t_max=8, width=2)


@pytest.mark.parametrize("option", ["draft", "prefix_rows", "mesh",
                                    "quantize_int8"])
def test_unported_engine_options_raise(option):
    from paddle_tpu_torch.serving import ServingEngine

    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        ServingEngine(exe, _tiny(port_gpt2.GPT2Config), n_slots=2, width=2,
                      t_max=8, **{option: "self" if option == "draft" else 1})


def test_executor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        ptt.Executor(ptt.CUDAPlace(0))
    assert ptt.Executor(ptt.CPUPlace()).device.type == "cpu"


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    """Weights go where the executor runs by default: the card, which
    raises without one; the CPU only when asked for."""
    from paddle_tpu_torch.io import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scope = ptt.Scope()
    w = {"w": np.ones((2, 3), "float32")}
    with pytest.raises(RuntimeError, match="CPUPlace"):
        params_from_numpy(w, scope)
    assert not scope.has_var("w")
    assert params_from_numpy(w, scope, ptt.CPUPlace()) == ["w"]
    assert scope.find_var("w").device.type == "cpu"


def test_cache_startup_and_reset_run_on_cpu():
    """The cache startup zeroes every cache; the reset program zeroes
    exactly the slots whose keep mask is 0."""
    hp = _tiny(port_gpt2.GPT2Config)
    _, start, _, _, names = port_gpt2.gpt2_ragged_step_program(
        hp, batch=3, t_max=8, width=2)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    scope = ptt.global_scope()
    for n in names:
        scope.set(n, torch.ones(3, 4, 8, 16))
    reset = port_dc.make_slot_reset_program(
        [(n, (3, 4, 8, 16)) for n in names], 3)
    exe.run(reset, feed={"slot_keep": np.array([1, 0, 1], "float32")})
    for n in names:
        v = scope.find_var(n)
        assert float(v[1].abs().sum()) == 0.0
        assert bool((v[[0, 2]] == 1).all())
    exe.run(start)
    assert all(float(scope.find_var(n).abs().sum()) == 0.0 for n in names)
