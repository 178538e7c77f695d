"""paddle_tpu_torch program builders against the reference builders: the
ragged serving step, its slot-reset and cache-startup programs, and the
GPT-2 logits program with its startup have the reference's op sequence
(types, slot names, var names, attrs), parameter names, and every var's
inferred shape and dtype.  Dtypes compare up to the dtype policy:
the reference runs int64 as int32 on the device, the port keeps int64.
The modern-decoder options (SwiGLU, rotary, grouped-query attention)
build the reference's programs, training and serving.  Also: the engine
options still to be ported raise, and Executor() with no CUDA device
raises."""

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


_MODERN = {
    "swiglu": dict(use_swiglu=True, ffn_multiple_of=8),
    "rotary": dict(use_rotary=True),
    "gqa": dict(n_kv_head=2),
    "all": dict(use_swiglu=True, ffn_multiple_of=8, use_rotary=True,
                n_kv_head=2),
}


def _both(builder, option, **kw):
    """The reference's and the port's `builder` on the tiny config with
    the `option` set."""
    return (getattr(ref_gpt2, builder)(
                _tiny(ref_gpt2.GPT2Config, **_MODERN[option]), **kw),
            getattr(port_gpt2, builder)(
                _tiny(port_gpt2.GPT2Config, **_MODERN[option]), **kw))


@pytest.mark.parametrize("option", sorted(_MODERN))
def test_modern_decoder_training_program_matches_reference(option):
    """The GPT-2 training program (forward, fuse passes, backward, Adam)
    with each modern-decoder option alone and all three together, op for
    op: one fused_swiglu per layer under SwiGLU, RoPE on q and k and no
    position table under rotary, narrowed k/v projections and expand
    under GQA."""
    (r_main, r_start, _, _), (p_main, p_start, _, _) = _both(
        "gpt2_lm_program", option, seq_len=16)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    for count in ("_swiglu_fused_count", "_fc_fused_count",
                  "_residual_ln_fused_count", "_matmul_epilogue_fused_count",
                  "_linear_xent_fused_count"):
        assert getattr(p_main, count) == getattr(r_main, count), count
    hp = _MODERN[option]
    types = [o.type for o in p_main.global_block().ops]
    n_layer = 2
    swiglu = hp.get("use_swiglu", False)
    assert p_main._swiglu_fused_count == (n_layer if swiglu else 0)
    assert types.count("fused_swiglu") == types.count(
        "fused_swiglu_grad") == (n_layer if swiglu else 0)
    assert "swish" not in types  # every gate folded into its fused_swiglu
    assert types.count("rotary_embed") == (
        2 * n_layer if hp.get("use_rotary") else 0)
    assert types.count("expand") == (2 * n_layer if "n_kv_head" in hp else 0)
    params = {p.name: tuple(p.shape)
              for p in p_main.global_block().all_parameters()}
    assert ("pos_emb.w_0" in params) != bool(hp.get("use_rotary"))
    assert params["mha_k.w_0"] == (64, 16 * (2 if "n_kv_head" in hp else 4))
    if swiglu:  # 2/3 of 4 x 64 = 170, rounded up to a multiple of 8
        assert params["ffn_gate.w_0"] == params["ffn_up.w_0"] == (64, 176)
        assert "ffn_in.w_0" not in params


@pytest.mark.parametrize("option", sorted(_MODERN))
def test_modern_decoder_serving_programs_match_reference(option):
    """The logits program with its startup, and the ragged serving step
    with its cache startup and slot reset: n_kv_head caches, pos_mat
    rotating q and k, fused_swiglu in the step."""
    hp_kw = _MODERN[option]
    for r, p in (_both("gpt2_logits_program", option, seq_len=16),
                 _both("gpt2_ragged_step_program", option, batch=3, t_max=24,
                       width=4)):
        _assert_same_program(r[0], p[0])
        _assert_same_program(r[1], p[1])
    n_kv = hp_kw.get("n_kv_head", 4)
    names = p[4]
    assert names == r[4]
    for n in names:
        assert p[0].global_block().var(n).shape == (3, n_kv, 24, 16)
    shapes = [(n, (3, n_kv, 24, 16)) for n in names]
    _assert_same_program(ref_dc.make_slot_reset_program(shapes, 3),
                         port_dc.make_slot_reset_program(shapes, 3))
    step_types = [o.type for o in p[0].global_block().ops]
    assert step_types.count("fused_swiglu") == (
        2 if hp_kw.get("use_swiglu") else 0)
    assert p[0]._swiglu_fused_count == r[0]._swiglu_fused_count
    if hp_kw.get("use_rotary"):
        rot = [o for o in p[0].global_block().ops if o.type == "rotary_embed"]
        assert len(rot) == 4 and all(o.inputs["Pos"] == ["pos_mat"]
                                     for o in rot)


def test_ragged_rotary_cache_needs_pos_mat():
    """The reference's guard: a ragged cache under rotary without
    pos_mat would rotate every slot at arange(W)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer as tfm

    x = layers.data("x", shape=[2, 4, 64], dtype="float32",
                    append_batch_size=False)
    rows = layers.data("rows", shape=[2], dtype="int64",
                       append_batch_size=False)
    blk = framework.default_main_program().global_block()
    cache = {nm: blk.create_var(name=nm, shape=[2, 4, 8, 16],
                                dtype="float32", persistable=True)
             for nm in ("k", "v")}
    cache.update(pos_rows=rows, width_rows=rows)
    with pytest.raises(ValueError, match="pos_mat"):
        tfm.multi_head_attention(x, x, x, None, 64, 4, cache=cache,
                                 fused=True, rotary=True)
    with pytest.raises(ValueError, match="kv heads"):
        tfm.multi_head_attention(x, x, x, None, 64, 4, cache=cache,
                                 fused=True, n_kv_head=2)


@pytest.mark.parametrize("option", ["mesh", "quantize_int8"])
def test_unported_engine_options_raise(option):
    from paddle_tpu_torch.serving import ServingEngine

    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        ServingEngine(exe, _tiny(port_gpt2.GPT2Config), n_slots=2, width=2,
                      t_max=8, **{option: 1})


@pytest.mark.parametrize("case", ["spec_k_below_2", "spec_k_above_width",
                                  "prefix_chunk_not_a_width_multiple",
                                  "register_prefix_without_prefix_rows"])
def test_engine_invalid_spec_and_prefix_values_raise(case):
    """The speculative and prefix-cache options raise on the values the
    reference refuses, as the reference does."""
    from paddle_tpu.serving import ServingEngine as RefEngine
    from paddle_tpu_torch.serving import ServingEngine

    kw, exc, match = {
        "spec_k_below_2": (dict(draft="self", spec_k=1), AssertionError,
                           "spec_k"),
        "spec_k_above_width": (dict(draft="self", spec_k=5), AssertionError,
                               "spec_k"),
        "prefix_chunk_not_a_width_multiple": (
            dict(prefix_rows=1, prefix_chunk=6), AssertionError, "6"),
        "register_prefix_without_prefix_rows": (
            {}, RuntimeError, "prefix_rows")}[case]
    for engine, exe, cfg in (
            (RefEngine, paddle_tpu.Executor(paddle_tpu.CPUPlace()),
             _tiny(ref_gpt2.GPT2Config)),
            (ServingEngine, ptt.Executor(ptt.CPUPlace()),
             _tiny(port_gpt2.GPT2Config))):
        with pytest.raises(exc, match=match):
            eng = engine(exe, cfg, n_slots=2, width=4, t_max=8, **kw)
            eng.register_prefix(np.arange(1, 9))


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


def _scale_program():
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[3], dtype="float32")
        y = ptt.layers.scale(x, scale=2.0)
    return main, y


def test_executor_run_takes_the_reference_signature():
    """exe.run(program, feed, fetch_list, feed_var_name, fetch_var_name,
    scope, return_numpy, use_program_cache), positional as in the
    reference: the same fetches as the keyword call, and the scope lands
    where it is named."""
    main, y = _scale_program()
    feed = {"x": np.arange(6, dtype="float32").reshape(2, 3)}
    exe = ptt.Executor(ptt.CPUPlace())
    (want,) = exe.run(main, feed=feed, fetch_list=[y])
    scope = ptt.Scope()
    (got,) = exe.run(main, feed, [y], "feed", "fetch", scope, True, True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, 2 * feed["x"])
    (cached,) = exe.run(main, feed=feed, fetch_list=[y],
                        use_program_cache=True)
    np.testing.assert_array_equal(cached, want)
    (raw,) = exe.run(main, feed, [y], "feed", "fetch", scope, False)
    assert isinstance(raw, torch.Tensor)
    np.testing.assert_array_equal(raw.numpy(), want)


def test_as_numpy_maps_over_lists():
    from paddle_tpu_torch.executor import as_numpy

    out = as_numpy([torch.ones(2), (torch.zeros(1), 3)])
    assert isinstance(out, list) and isinstance(out[1], list)
    np.testing.assert_array_equal(out[0], np.ones(2, "float32"))
    np.testing.assert_array_equal(out[1][0], np.zeros(1, "float32"))
    assert out[1][1] == 3


def test_ragged_step_program_positional_cache_dtype():
    """A reference-style positional call: the fifth argument is
    cache_dtype, so the caches keep the reference's gpt2_ prefix."""
    r_main, _, _, _, r_names = ref_gpt2.gpt2_ragged_step_program(
        _tiny(ref_gpt2.GPT2Config), 2, 32, 4, "float32")
    p_main, _, _, _, p_names = port_gpt2.gpt2_ragged_step_program(
        _tiny(port_gpt2.GPT2Config), 2, 32, 4, "float32")
    assert p_names == r_names
    assert "gpt2_kcache_0" in p_names
    assert all(n.startswith("gpt2_") for n in p_names)
    _assert_same_program(r_main, p_main)
    # bf16 caches (ported): the same program as the reference's
    r_main, r_start, _, _, r_names = ref_gpt2.gpt2_ragged_step_program(
        _tiny(ref_gpt2.GPT2Config), 2, 32, 4, "bfloat16")
    p_main, p_start, _, _, p_names = port_gpt2.gpt2_ragged_step_program(
        _tiny(port_gpt2.GPT2Config), 2, 32, 4, "bfloat16")
    assert p_names == r_names
    _assert_same_program(r_main, p_main)
    _assert_same_program(r_start, p_start)
    blk = p_main.global_block()
    assert all(str(blk.vars[n].dtype) == "bfloat16" for n in p_names)


@pytest.mark.parametrize("option, item", [
    ("partition_rules", "A7"), ("mp_axis", "A7"), ("cache_dtype", "A3")])
def test_engine_reference_options_raise(option, item):
    """The options that wait for their ROADMAP item raise naming it;
    cache_dtype="bfloat16" (A3 (b), ported) builds an engine whose slot
    reset keeps the pool bf16."""
    from paddle_tpu_torch.serving import ServingEngine

    exe = ptt.Executor(ptt.CPUPlace())
    value = {"cache_dtype": "bfloat16", "mp_axis": "mp"}.get(option, 2)
    if option == "cache_dtype":
        eng = ServingEngine(exe, _tiny(port_gpt2.GPT2Config), n_slots=2,
                            width=2, t_max=8, **{option: value})
        blk = eng.step_main.global_block()
        assert all(str(blk.vars[n].dtype) == "bfloat16"
                   for n in eng.cache_names)
        assert "cast" in [o.type for o in eng.reset_prog.global_block().ops]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP " + item):
        ServingEngine(exe, _tiny(port_gpt2.GPT2Config), n_slots=2, width=2,
                      t_max=8, **{option: value})


def test_engine_takes_the_reference_parameter_order():
    """ServingEngine(exe, hp, n_slots, width, t_max, cache_dtype, ...)
    positional as in the reference: the sixth argument is cache_dtype."""
    import inspect

    from paddle_tpu.serving import ServingEngine as RefEngine
    from paddle_tpu_torch.serving import ServingEngine

    assert (list(inspect.signature(ServingEngine.__init__).parameters)
            == list(inspect.signature(RefEngine.__init__).parameters))
    exe = ptt.Executor(ptt.CPUPlace())
    eng = ServingEngine(exe, _tiny(port_gpt2.GPT2Config), 2, 2, 8, "float32")
    assert eng.cache_names[0].startswith("gpt2_")
    eng16 = ServingEngine(exe, _tiny(port_gpt2.GPT2Config), 2, 2, 8,
                          "bfloat16")
    assert eng16.cache_dtype == "bfloat16"
    blk = eng16.step_main.global_block()
    assert str(blk.vars[eng16.cache_names[0]].dtype) == "bfloat16"


def test_variable_type_in_the_reference_position():
    """Variable's `type` sits between stop_gradient and is_data with the
    reference's default, is kept as var.type, and Block.create_var
    passes it through (it was swallowed by **kwargs)."""
    import paddle_tpu as pfluid

    ref_block = pfluid.Program().global_block()
    port_block = ptt.Program().global_block()
    for pkg, block in ((pfluid.framework, ref_block),
                       (framework, port_block)):
        args = (block, "v", [2, 3], "float32", 0, True, False,
                pkg.VarType.LOD_TENSOR_ARRAY, True)
        v = pkg.Variable(*args)
        assert v.type == pkg.VarType.LOD_TENSOR_ARRAY and v.is_data is True
        assert v.persistable is True and v.stop_gradient is False
        w = block.create_var(name="w", shape=[4], dtype="int64",
                             type=pkg.VarType.SELECTED_ROWS)
        assert w.type == pkg.VarType.SELECTED_ROWS
        d = block.create_var(name="d", shape=[4], dtype="float32")
        assert d.type == pkg.VarType.LOD_TENSOR and d.is_data is False
    for name in ("LOD_TENSOR", "SELECTED_ROWS", "LOD_TENSOR_ARRAY",
                 "STEP_SCOPES", "READER", "RAW"):
        assert getattr(framework.VarType, name) == getattr(
            pfluid.framework.VarType, name)
