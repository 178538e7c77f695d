"""The port's inference deployment path on the CPU, against the
reference: ``Program.to_json`` / ``from_json`` / ``clone`` / ``_prune``,
``io``'s save and load, and the ``AnalysisConfig`` predictor.

- The JSON of the same built programs (WMT, GPT-2, ResNet-50), parsed,
  is equal in both packages up to the dtype policy (the reference runs
  int64 as int32 on the device and writes some index vars int32), and
  ``from_json`` in either package reads the other's.
- A model saved by either package's ``save_inference_model`` is served
  by both packages' ``AnalysisConfig`` predictors on the CPU: a CIFAR
  ResNet at depth 8 on 3x16x16 with seeded batch-norm statistics, the
  analyzer's tiny Transformer encoder (``TinyHP``), a 2-layer LSTM
  classifier at widths of 16 and the 2-``fc`` MLP.  After the 12-pass
  pipeline the op types are equal, the folded weights bit-equal (the
  fold's arithmetic is the reference's numpy float32), and the outputs
  within rtol 1e-4, atol 1e-5 (summation order only).
- The loader's version gate and the binary ``__model__`` raise, and the
  predictor's zero-copy, PaddleTensor and clone modes, as the
  reference's tests hold them.
"""

import importlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.inference import AnalysisConfig as RefAnalysisConfig
from paddle_tpu.inference import create_paddle_predictor as ref_predictor
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                        PaddleTensor, create_paddle_predictor)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = dict(rtol=1e-4, atol=1e-5)


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


def _mod(pkg, name):
    return importlib.import_module(pkg.__name__ + "." + name)


def _types(program):
    return [op.type for op in program.global_block().ops]


def _normalized(text):
    """A program's JSON, parsed, with int32 var dtypes read as int64:
    the reference's dtype policy for index vars (top_k, accuracy)."""
    data = json.loads(text)
    for b in data["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
    return data


# ---------------------------------------------------------------------------
# the models, the same calls in both packages
# ---------------------------------------------------------------------------
T_ENC = 16
T_LSTM = 7


def _resnet(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("image", shape=[3, 16, 16])
        pred = _mod(pkg, "models.resnet").resnet_cifar10(img, 10, depth=8)
    feed = {"image": np.random.RandomState(1).rand(2, 3, 16, 16).astype(
        "float32")}
    return main, startup, ["image"], pred, feed


def _tiny_hp(pkg):
    tfm = _mod(pkg, "models.transformer")

    class TinyHP(tfm.ModelHyperParams):
        src_vocab_size = 128
        max_length = 32
        d_model = 32
        d_inner_hid = 64
        n_head = 4
        n_layer = 2
        dropout = 0.1

    return tfm, TinyHP


def _encoder(pkg, with_loss=False):
    """The reference analyzer's encoder classifier
    (tests/test_inference_models.py:133-160) with a rank-1 key-padding
    bias [B, 1, 1, T] padding the last two keys."""
    tfm, hp = _tiny_hp(pkg)
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = L.data("src_ids", shape=[T_ENC], dtype="int64")
        bias = L.data("src_bias", shape=[1, 1, T_ENC])
        x = tfm.prepare_embedding(ids, hp.src_vocab_size, hp.d_model,
                                  hp.max_length, hp.dropout,
                                  "src_pos_enc_table")
        for _ in range(hp.n_layer):
            x = tfm.encoder_layer(x, bias, hp)
        pred = L.fc(L.reduce_mean(x, dim=1), size=4, act="softmax")
        if with_loss:
            label = L.data("label", shape=[1], dtype="int64")
            loss = L.mean(L.cross_entropy(pred, label))
            _mod(pkg, "optimizer").Adam(1e-3).minimize(loss)
    rng = np.random.RandomState(1)
    b = np.zeros((4, 1, 1, T_ENC), "float32")
    b[..., -2:] = -1e9
    feed = {"src_ids": rng.randint(1, hp.src_vocab_size,
                                   (4, T_ENC)).astype("int64"),
            "src_bias": b}
    return main, startup, ["src_ids", "src_bias"], pred, feed


def _lstm(pkg):
    """embedding -> fc -> LSTM -> fc -> LSTM, max-pooled over the valid
    steps, softmax: the embedding_fc_lstm and fc_lstm fuse passes' two
    patterns, at widths of 16."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        words = L.data("words", shape=[T_LSTM], dtype="int64")
        seq_len = L.data("seq_len", shape=[], dtype="int64")
        emb = L.embedding(words, size=[50, 16])
        h1, _ = L.dynamic_lstm(L.fc(emb, 64, num_flatten_dims=2), 64,
                               seq_len=seq_len)
        h2, _ = L.dynamic_lstm(L.fc(h1, 64, num_flatten_dims=2), 64,
                               seq_len=seq_len)
        pooled = L.sequence_pool(h2, pool_type="max", seq_len=seq_len)
        pred = L.fc(pooled, 2, act="softmax")
    rng = np.random.RandomState(2)
    feed = {"words": rng.randint(0, 50, (3, T_LSTM)).astype("int64"),
            "seq_len": np.array([7, 4, 1], "int64")}
    return main, startup, ["words", "seq_len"], pred, feed


def _mlp(pkg):
    """The 2-fc MLP of tests/test_fuse_passes.py:233."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[8])
        pred = L.fc(L.fc(x, 16, act="relu"), 4, act="softmax")
    feed = {"x": np.random.RandomState(7).rand(3, 8).astype("float32")}
    return main, startup, ["x"], pred, feed


MODELS = {"resnet": _resnet, "encoder": _encoder, "lstm": _lstm, "mlp": _mlp}


def _seed_bn(main, put, seed=0):
    """Non-trivial batch-norm statistics: gamma, beta and mean from
    normal draws, the variance uniform in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    block = main.global_block()
    for op in block.ops:
        if op.type != "batch_norm":
            continue
        c = int(block.var(op.inputs["Scale"][0]).shape[0])
        put(op.inputs["Scale"][0], rng.normal(1.0, 0.2, c))
        put(op.inputs["Bias"][0], rng.normal(0.0, 0.2, c))
        put(op.inputs["Mean"][0], rng.normal(0.0, 0.2, c))
        put(op.inputs["Variance"][0], rng.uniform(0.5, 1.5, c))


def _save_reference(kind, d):
    main, startup, feeds, pred, feed = MODELS[kind](fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        _seed_bn(main, lambda n, v: scope.set(n, v.astype("float32")))
        fluid.save_inference_model(d, feeds, [pred], exe, main_program=main)
    return feed


def _save_port(kind, d):
    main, startup, feeds, pred, feed = MODELS[kind](ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    _seed_bn(main, lambda n, v: scope.set(n, torch.tensor(v, dtype=torch.float32)))
    ptt.save_inference_model(d, feeds, [pred], exe, main_program=main,
                             scope=scope)
    return feed, main, scope, pred


@pytest.mark.parametrize("saver", ["reference", "port"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_saved_model_served_by_both_predictors(tmp_path, kind, saver):
    d = str(tmp_path / kind)
    if saver == "reference":
        feed = _save_reference(kind, d)
    else:
        feed, main, scope, pred = _save_port(kind, d)
    ref = ref_predictor(RefAnalysisConfig(d))
    port = create_paddle_predictor(AnalysisConfig(d, place=ptt.CPUPlace()))
    types = _types(port.program)
    assert types == _types(ref.program)
    assert port.feed_names == ref.feed_names
    assert port.fetch_names == ref.fetch_names
    for v in port.program.list_vars():
        if v.persistable and ref.scope.find_var(v.name) is not None:
            got = port.scope.find_var(v.name)
            assert got.device.type == "cpu", v.name
            assert np.array_equal(got.numpy(),
                                  np.asarray(ref.scope.find_var(v.name))), v.name
    (want,) = ref.run(feed)
    (got,) = port.run(feed)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if kind == "resnet":
        assert "batch_norm" not in types
        assert types.count("conv2d") == 9
        assert types.count("fused_elemwise_activation") == 3
    elif kind == "encoder":
        assert types.count("fused_attention") == 2
        assert "dropout" not in types and "softmax" in types
        assert port.program._attention_fused_count == 2
    elif kind == "lstm":
        assert types[:2] == ["fused_embedding_fc_lstm", "fusion_lstm"]
        assert port.program._emb_fc_lstm_fused_count == 1
        assert port.program._fc_lstm_fused_count == 1
    else:
        assert types == ["fc", "fc", "softmax"]
    assert port.program._memory_opt_plan == ref.program._memory_opt_plan
    if saver == "port":
        # the unfolded program on the port's own executor agrees too
        exe = ptt.Executor(ptt.CPUPlace())
        (plain,) = exe.run(main.clone(for_test=True), feed=feed,
                           fetch_list=[pred], scope=scope)
        np.testing.assert_allclose(got, plain, **TOL)


# ---------------------------------------------------------------------------
# Program serialization, clone, prune
# ---------------------------------------------------------------------------
def _built(pkg, which):
    if which == "resnet50":
        return _mod(pkg, "models.resnet").build_resnet_train_program()[0]
    if which == "wmt":
        tfm = _mod(pkg, "models.transformer")

        class Tiny(tfm.ModelHyperParams):
            n_layer = 1
            src_vocab_size = trg_vocab_size = 61

        return tfm.wmt_transformer_program(Tiny, src_len=8, trg_len=8)[0]
    gpt2 = _mod(pkg, "models.gpt2")

    class Tiny(gpt2.GPT2Config):
        vocab_size = 61
        n_ctx = 32
        d_model = 64
        n_layer = 2
        n_head = 4

    return gpt2.gpt2_lm_program(Tiny, seq_len=16)[0]


def _ops_and_vars(program):
    b = program.global_block()
    return ([op.to_dict() for op in b.ops],
            {n: v.to_dict() for n, v in b.vars.items()})


@pytest.mark.parametrize("which", ["wmt", "gpt2", "resnet50"])
def test_program_json_matches_reference(which):
    with fluid.unique_name.guard():
        ref = _built(fluid, which)
    port = _built(ptt, which)
    r_json, p_json = ref.to_json(), port.to_json()
    assert _normalized(p_json) == _normalized(r_json)
    # from_json in both directions: op lists and var dicts equal
    from_ref = framework.Program.from_json(r_json)
    from_port = fluid.Program.from_json(p_json)
    assert _ops_and_vars(from_ref) == _ops_and_vars(
        fluid.Program.from_json(r_json))
    assert _ops_and_vars(from_port) == _ops_and_vars(
        framework.Program.from_json(p_json))
    assert json.loads(from_ref.to_json()) == json.loads(r_json)
    assert from_ref.num_blocks == 1
    assert sorted(v.name for v in from_ref.list_vars()) == sorted(
        v.name for v in ref.list_vars())


def test_clone_for_test_and_prune_match_reference():
    """The encoder classifier's training program (Adam): clone and
    clone(for_test=True) (every dropout and is_test attr flipped) and
    _prune to the prediction, against the reference's."""
    with fluid.unique_name.guard():
        r_main, _, _, r_pred, _ = _encoder(fluid, with_loss=True)
    p_main, _, _, p_pred, _ = _encoder(ptt, with_loss=True)
    for args in ({}, {"for_test": True}):
        r, p = r_main.clone(**args), p_main.clone(**args)
        assert _normalized(p.to_json()) == _normalized(r.to_json())
        assert p._is_test == r._is_test == bool(args)
    drops = [op for op in p_main.clone(for_test=True).global_block().ops
             if op.type == "dropout"]
    assert drops and all(op.attrs["is_test"] for op in drops)
    r_pruned = r_main.clone(for_test=True)._prune([r_pred])
    p_pruned = p_main.clone(for_test=True)._prune([p_pred])
    assert _normalized(p_pruned.to_json()) == _normalized(r_pruned.to_json())
    assert "adam" not in _types(p_pruned) and "softmax" in _types(p_pruned)
    # the original is untouched
    assert "adam" in _types(p_main)


def test_clone_shares_the_spmd_stamp_and_slice_raises_on_sub_blocks():
    main, _, _, pred, _ = _mlp(ptt)
    main._spmd = {"mesh": object(), "group": torch.Generator()}
    c = main.clone()
    assert c._spmd is main._spmd
    assert c.global_block() is not main.global_block()
    main.global_block().ops[-1].attrs["sub_block"] = 1
    with pytest.raises(NotImplementedError, match="A6c"):
        framework.backward_slice_keep(main, {pred.name})


# ---------------------------------------------------------------------------
# io: layouts, version gate, formats
# ---------------------------------------------------------------------------
def test_version_field_written_and_roundtrips(tmp_path):
    main, startup, feeds, pred, feed = _mlp(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path / "m")
    assert ptt.save_inference_model(d, feeds, [pred], exe, main_program=main,
                                    scope=scope) == [pred.name]
    meta = json.load(open(os.path.join(d, "__model__")))
    assert meta["version"] == ptt.io.PROGRAM_FORMAT_VERSION == 1
    scope2 = ptt.Scope()
    prog, feed_names, fetches = ptt.load_inference_model(d, exe, scope=scope2)
    assert feed_names == feeds and [v.name for v in fetches] == [pred.name]
    (out,) = exe.run(prog, feed=feed, fetch_list=fetches, scope=scope2)
    (want,) = exe.run(main, feed=feed, fetch_list=[pred], scope=scope)
    np.testing.assert_array_equal(out, want)


def test_versionless_fixture_loads_and_future_version_refused(tmp_path):
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    fixture = os.path.join(FIXTURES, "saved_model_r2")
    prog, feeds, fetches = ptt.load_inference_model(fixture, exe, scope=scope)
    x = np.arange(8, dtype="float32").reshape(2, 4) / 10.0
    (out,) = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches,
                     scope=scope)
    np.testing.assert_allclose(out, np.load(fixture + "_expected.npy"),
                               rtol=1e-5, atol=1e-6)
    assert ptt.io.is_program_version_supported(0)
    assert not ptt.io.is_program_version_supported(2)
    d = str(tmp_path / "future")
    shutil.copytree(fixture, d)
    p = os.path.join(d, "__model__")
    meta = json.load(open(p))
    meta["version"] = ptt.io.PROGRAM_FORMAT_VERSION + 1
    json.dump(meta, open(p, "w"))
    with pytest.raises(RuntimeError, match="newer"):
        ptt.load_inference_model(d, exe)


def test_binary_model_raises_naming_desc_codec(tmp_path):
    main, startup, feeds, pred, _ = _mlp(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(NotImplementedError, match="A9"):
        ptt.save_inference_model(str(tmp_path / "pb"), feeds, [pred], exe,
                                 main_program=main, model_format="pb")
    with pytest.raises(NotImplementedError, match="desc_codec"):
        ptt.load_inference_model(os.path.join(FIXTURES, "saved_model_r3_pb"),
                                 exe)
    with pytest.raises(ValueError, match="model_format"):
        ptt.save_inference_model(str(tmp_path / "x"), feeds, [pred], exe,
                                 main_program=main, model_format="yaml")


@pytest.mark.parametrize("filename", [None, "params"])
def test_persistables_layout_matches_reference(tmp_path, filename):
    """save_persistables / load_persistables in the reference's layout
    (one .npy a var, '/' as %2F; or one npz blob): the port's files load
    in the reference and the reference's in the port, value for value,
    onto the executor's place."""
    main, startup, _, _, _ = _mlp(ptt)
    main.global_block().create_var(name="a/b", shape=[2], dtype="float32",
                                   persistable=True)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    scope.set("a/b", torch.tensor([1.5, -2.0]))
    d = str(tmp_path / "p")
    ptt.io.save_persistables(exe, d, main, filename=filename, scope=scope)
    if filename is None:
        assert os.path.exists(os.path.join(d, "a%2Fb.npy"))
    names = [v.name for v in main.list_vars() if v.persistable]
    blob = filename and filename + ".npz"
    r_scope = fluid.Scope()
    r_main = fluid.Program.from_json(main.to_json())
    fluid.io.load_persistables(fluid.Executor(fluid.CPUPlace()), d, r_main,
                               filename=blob, scope=r_scope)
    p_scope = ptt.Scope()
    ptt.io.load_persistables(exe, d, main, filename=blob, scope=p_scope)
    for n in names:
        want = scope.find_var(n).numpy()
        assert np.array_equal(np.asarray(r_scope.find_var(n)), want), n
        assert np.array_equal(p_scope.find_var(n).numpy(), want), n
        assert isinstance(p_scope.find_var(n), torch.Tensor)
    d2 = str(tmp_path / "r")
    fluid.io.save_persistables(fluid.Executor(fluid.CPUPlace()), d2, r_main,
                               filename=filename, scope=r_scope)
    p2 = ptt.Scope()
    ptt.io.load_persistables(exe, d2, main, filename=blob, scope=p2)
    for n in names:
        assert np.array_equal(p2.find_var(n).numpy(),
                              scope.find_var(n).numpy()), n


# ---------------------------------------------------------------------------
# the predictor's modes
# ---------------------------------------------------------------------------
def _conv_model(tmp_path):
    """A conv -> batch_norm -> relu -> global pool -> dropout -> fc
    softmax program trained 3 SGD steps on the CPU, saved; returns the
    model dir, the images and the prediction of its forward's
    clone(for_test=True)."""
    L = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        img = L.data("img", shape=[3, 8, 8])
        label = L.data("label", shape=[1], dtype="int64")
        c = L.conv2d(img, num_filters=4, filter_size=3, act=None)
        pool = L.pool2d(L.relu(L.batch_norm(c)), pool_type="avg",
                        global_pooling=True)
        pred = L.fc(L.dropout(pool, 0.3), size=10, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        test_prog = main.clone(for_test=True)
        _mod(ptt, "optimizer").SGD(0.1).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    x = rng.rand(8, 3, 8, 8).astype("float32")
    y = rng.randint(0, 10, (8, 1)).astype("int64")
    for _ in range(3):
        exe.run(main, feed={"img": x, "label": y}, fetch_list=[loss],
                scope=scope)
    d = str(tmp_path / "model")
    ptt.save_inference_model(d, ["img"], [pred], exe, main_program=main,
                             scope=scope)
    (ref,) = exe.run(test_prog, feed={"img": x}, fetch_list=[pred],
                     scope=scope)
    return d, x, ref


def test_predictor_parity_fold_and_clone(tmp_path):
    d, x, ref = _conv_model(tmp_path)
    native = create_paddle_predictor(NativeConfig(d, place=ptt.CPUPlace()))
    # ir_optim off: the clone(for_test=True) program as saved
    assert {"batch_norm", "dropout"} <= set(_types(native.program))
    (out_n,) = native.run({"img": x})
    np.testing.assert_allclose(out_n, ref, rtol=2e-4, atol=1e-5)
    pred = create_paddle_predictor(AnalysisConfig(d, place=ptt.CPUPlace()))
    types = _types(pred.program)
    assert "batch_norm" not in types and "dropout" not in types
    (out,) = pred.run({"img": x})
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    clone = pred.clone()  # positional inputs; the weights shared
    assert clone.scope is pred.scope and clone.exe is not pred.exe
    (out2,) = clone.run([x])
    np.testing.assert_allclose(out2, out, rtol=1e-6)
    assert pred.get_input_names() == ["img"]
    assert pred.get_output_names() == pred.fetch_names


def test_zero_copy_and_paddle_tensor_modes(tmp_path):
    d, x, ref = _conv_model(tmp_path)
    pred = create_paddle_predictor(AnalysisConfig(d, place=ptt.CPUPlace()))
    inp = pred.get_input_tensor("img")
    inp.reshape(x.shape)
    buf = inp.mutable_data("float32")
    buf[...] = x
    assert pred.zero_copy_run()
    out_name = pred.get_output_names()[0]
    out = pred.get_output_tensor(out_name).copy_to_cpu()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-5)
    assert pred.get_output_tensor(out_name).shape() == list(ref.shape)
    buf[...] = x * 0.0  # the same buffer, written in place
    pred.zero_copy_run()
    assert not np.allclose(pred.get_output_tensor(out_name).copy_to_cpu(),
                           out)
    inp.copy_from_cpu(x)
    pred.zero_copy_run()
    np.testing.assert_allclose(pred.get_output_tensor(out_name).copy_to_cpu(),
                               ref, rtol=2e-4, atol=1e-5)
    with pytest.raises(KeyError):
        pred.get_input_tensor("nope")
    with pytest.raises(RuntimeError, match="for input tensors"):
        pred.get_output_tensor(out_name).mutable_data()
    fresh = create_paddle_predictor(NativeConfig(d, place=ptt.CPUPlace()))
    with pytest.raises(RuntimeError, match="reshape"):
        fresh.get_input_tensor("img").mutable_data()
    with pytest.raises(RuntimeError, match="zero_copy_run"):
        fresh.get_output_tensor(out_name).copy_to_cpu()
    with pytest.raises(RuntimeError, match="not bound"):
        fresh.zero_copy_run()
    (out_t,) = fresh.run([PaddleTensor(x, name="img")])
    assert isinstance(out_t, PaddleTensor) and out_t.name == out_name
    assert out_t.dtype == "float32" and out_t.shape == list(ref.shape)
    np.testing.assert_allclose(out_t.data, ref, rtol=2e-4, atol=1e-5)


def test_pass_list_resolved_before_any_mutation(tmp_path, monkeypatch):
    """A registered pass runs in the pipeline by name; an unknown name
    (or a pass not ported yet) raises before any pass has run."""
    from paddle_tpu_torch import transpiler
    from paddle_tpu_torch.transpiler import pass_registry

    d, x, _ = _conv_model(tmp_path)
    calls = []

    @transpiler.register_pass("test_probe_pass")
    def _probe(program, scope):
        calls.append(len(program.global_block().ops))
        return program

    try:
        cfg = AnalysisConfig(d, place=ptt.CPUPlace())
        cfg.pass_builder().append("test_probe_pass")
        pred = create_paddle_predictor(cfg)
        assert calls and pred.run({"img": x})[0].shape == (8, 10)
        applied = []
        monkeypatch.setattr(pass_registry, "apply_pass",
                            lambda *a, **k: applied.append(a))
        monkeypatch.setattr(transpiler, "apply_pass",
                            lambda *a, **k: applied.append(a))
        for bad, hint in (("no_such_pass", "known"),
                          ("bf16_amp_pass", "A3"), ("weight_int8_pass", "A6c"),
                          ("graph_viz_pass", "A9"), ("remat_pass", "A9")):
            cfg = AnalysisConfig(d, place=ptt.CPUPlace())
            cfg.pass_builder().insert(0, bad)
            with pytest.raises(KeyError, match=hint):
                create_paddle_predictor(cfg)
        assert not applied
    finally:
        pass_registry._PASSES.pop("test_probe_pass", None)


def test_entry_points_default_to_the_card_and_int8_waits(tmp_path):
    d, _, _ = _conv_model(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            create_paddle_predictor(AnalysisConfig(d))
        with pytest.raises(RuntimeError, match="CUDA"):
            ptt.load_inference_model(d, None)
    with pytest.raises(NotImplementedError, match="A6c"):
        AnalysisConfig(d).enable_int8()
    prog = ptt.Program()
    with pytest.raises(NotImplementedError, match="A6c"):
        ptt.InferenceTranspiler().transpile(prog, quantize_int8=True)


def test_inference_transpiler_matches_reference():
    """transpile(fetches=) on a clone(for_test=True) of a conv + bn +
    relu training program: the prune below the cut, the fold and the
    dropout rewrite give the reference's ops, and bit-equal weights."""
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            img = L.data("img", shape=[3, 8, 8])
            label = L.data("label", shape=[1], dtype="int64")
            c = L.conv2d(img, num_filters=4, filter_size=3, act=None)
            h = L.batch_norm(L.conv2d(L.relu(L.batch_norm(c)), 4, 3,
                                      bias_attr=False))
            pool = L.pool2d(h, pool_type="max", global_pooling=True)
            pred = L.fc(L.dropout(pool, 0.5), size=5, act="softmax")
            loss = L.mean(L.cross_entropy(pred, label))
            _mod(pkg, "optimizer").SGD(0.1).minimize(loss)
        return main, startup, pred

    with fluid.unique_name.guard():
        r_main, r_start, r_pred = build(fluid)
    p_main, _, p_pred = build(ptt)
    r_scope = fluid.Scope()
    with fluid.scope_guard(r_scope):
        fluid.Executor(fluid.CPUPlace()).run(r_start)
    _seed_bn(r_main, lambda n, v: r_scope.set(n, v.astype("float32")))
    names = [n for n, v in r_main.global_block().vars.items() if v.persistable]
    arrays = {n: np.asarray(r_scope.find_var(n)) for n in names}
    p_scope = ptt.Scope()
    ptt.io.params_from_numpy(arrays, p_scope, ptt.CPUPlace())
    from paddle_tpu.transpiler import InferenceTranspiler as RefT

    r_inf = RefT().transpile(r_main.clone(for_test=True), scope=r_scope,
                             fetches=[r_pred])
    p_inf = ptt.InferenceTranspiler().transpile(
        p_main.clone(for_test=True), scope=p_scope, fetches=[p_pred])
    assert _types(p_inf) == _types(r_inf)
    assert "batch_norm" not in _types(p_inf) and "sgd" not in _types(p_inf)
    assert _types(p_inf).count("scale") == 1  # the dropout's (1 - p)
    assert p_inf._is_test
    for n in set(p_scope.local_var_names()) | set(
            r_scope.local_var_names()):
        if n.endswith("@BN_FOLDED_BIAS") or n in names:
            assert np.array_equal(p_scope.find_var(n).numpy(),
                                  np.asarray(r_scope.find_var(n))), n


@pytest.mark.slow
def test_analyzer_resnet50_cycle(tmp_path):
    """The reference analyzer's ResNet-50 cycle (test_inference_models.py:
    41) on the port: 2 Momentum steps at 32x32, save, serve through the
    AnalysisConfig predictor (every batch_norm folded) against the
    training program's clone(for_test=True), within the reference's
    rtol 2e-3, atol 1e-5; and the reference's predictor on the same
    directory."""
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    L = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        img = L.data("image", shape=[3, 32, 32])
        label = L.data("label", shape=[1], dtype="int64")
        predict = resnet_imagenet(img, class_dim=10, depth=50)
        loss = L.mean(L.cross_entropy(predict, label))
        test_prog = main.clone(for_test=True)
        _mod(ptt, "optimizer").Momentum(0.01, momentum=0.9).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, (2, 1)).astype("int64")
    for _ in range(2):
        exe.run(main, feed={"image": x, "label": y}, fetch_list=[loss],
                scope=scope)
    d = str(tmp_path / "resnet50")
    ptt.save_inference_model(d, ["image"], [predict], exe, main_program=main,
                             scope=scope)
    (ref,) = exe.run(test_prog, feed={"image": x}, fetch_list=[predict],
                     scope=scope)
    pred = create_paddle_predictor(AnalysisConfig(d, place=ptt.CPUPlace()))
    types = _types(pred.program)
    assert "batch_norm" not in types and types.count("conv2d") == 53
    (out,) = pred.run({"image": x})
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=1e-5)
    (r_out,) = ref_predictor(RefAnalysisConfig(d)).run({"image": x})
    np.testing.assert_allclose(out, np.asarray(r_out), **TOL)
