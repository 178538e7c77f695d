"""The port's inference passes and the ops they produce, against the
reference, on the CPU.

- Each of the 15 passes registered with the inference path
  (``conv_bn_fuse_pass``, ``bn_fold_pass``, ``is_test_pass``,
  ``train_prune_pass``, ``memory_optimize_pass``, ``nhwc_layout_pass``,
  ``fuse_relu_into_conv_pass``, ``attention_fuse_pass``,
  ``fuse_elewise_add_act_pass``, ``conv_eltadd_relu_fuse_pass``,
  ``seqconv_eltadd_relu_fuse_pass``, ``fc_gru_fuse_pass``,
  ``fc_lstm_fuse_pass``, ``seqexpand_concat_fc_fuse_pass``,
  ``embedding_fc_lstm_fuse_pass``) runs on the same program built in
  both packages (the reference under ``unique_name.guard()``, the port
  under a fresh generator): the programs after it are equal op for op
  (types, slots, var names, attrs), the fused counts equal, and the
  port's outputs, from the reference's startup arrays, within the
  reference test's bound of the unfused program's and of the
  reference's.  The refusals: a training program left alone, two
  biases, a train-mode batch norm, protected fetches, a second reader.
- The sequence_conv and sequence_expand programs are made with
  ``block.append_op`` (neither layer is ported): the IR is compared;
  ``fusion_seqexpand_concat_fc``'s lowering is compared on numpy inputs.
- Every new op lowering (``gru`` / ``fusion_gru``, ``lstm`` /
  ``fusion_lstm``, ``fused_elemwise_activation``,
  ``fused_embedding_fc_lstm``, ``fusion_seqexpand_concat_fc``) against
  the reference lowering on shared numpy inputs (the op_test pattern),
  rtol = atol = 1e-5; the recurrent ones reach the kernel wrappers.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.transpiler import apply_pass as ref_apply
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.transpiler import apply_pass

from test_torch_ops import _check
from test_torch_program import _assert_same_program


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


class Pair:
    """One program built in both packages, with the reference's startup
    arrays in both scopes."""

    def __init__(self, build, feed):
        with fluid.unique_name.guard():
            self.r_main, r_start, self.r_fetch = build(fluid)
        self.p_main, _, self.p_fetch = build(ptt)
        self.feed = feed
        self.r_scope = fluid.Scope()
        with fluid.scope_guard(self.r_scope):
            fluid.Executor(fluid.CPUPlace()).run(r_start)
        arrays = {n: np.asarray(self.r_scope.find_var(n))
                  for n, v in self.r_main.global_block().vars.items()
                  if v.persistable and self.r_scope.find_var(n) is not None}
        self.p_scope = ptt.Scope()
        params_from_numpy(arrays, self.p_scope, ptt.CPUPlace())
        self.names = sorted(arrays)

    def put(self, name, value):
        """The same value into both scopes."""
        self.r_scope.set(name, value)
        self.p_scope.set(name, torch.tensor(value))

    def run_port(self):
        exe = ptt.Executor(ptt.CPUPlace())
        return exe.run(self.p_main, feed=self.feed, fetch_list=self.p_fetch,
                       scope=self.p_scope)

    def run_ref(self):
        with fluid.scope_guard(self.r_scope):
            out = fluid.Executor(fluid.CPUPlace()).run(
                self.r_main, feed=self.feed, fetch_list=self.r_fetch)
        return [np.asarray(o) for o in out]

    def apply(self, *names, scope=False):
        for name in names:
            ref_apply(self.r_main, name,
                      scope=self.r_scope if scope else None)
            apply_pass(self.p_main, name,
                       scope=self.p_scope if scope else None)
        _assert_same_program(self.r_main, self.p_main)

    def check(self, names, counter, n, scope=False, tol=(1e-5, 1e-6),
              run=True):
        """Apply `names` in both; the programs, the fused count and
        (with `run`) the outputs: the port's before and after, and the
        reference's after."""
        before = self.run_port() if run else None
        self.apply(*names, scope=scope)
        assert getattr(self.p_main, counter) == getattr(self.r_main,
                                                        counter) == n
        if run:
            rtol, atol = tol
            after = self.run_port()
            for a, b, r in zip(before, after, self.run_ref()):
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
                np.testing.assert_allclose(b, r, rtol=rtol, atol=atol)
        return self


_RNG = np.random.RandomState(3)


def _feed(**shapes):
    out = {}
    for name, (shape, dtype, hi) in shapes.items():
        out[name] = (_RNG.randint(0, hi, shape).astype(dtype)
                     if dtype == "int64" else
                     _RNG.rand(*shape).astype(dtype))
    return out


# ---------------------------------------------------------------------------
# the recurrent fusions
# ---------------------------------------------------------------------------
def _fc_gru(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[5, 6])
        h = L.dynamic_gru(L.fc(x, 3 * 4, num_flatten_dims=2, bias_attr=False),
                          size=4)
    return main, startup, [h]


def _fc_lstm(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[5, 6])
        seq_len = L.data("seq_len", shape=[], dtype="int64")
        h, c = L.dynamic_lstm(L.fc(x, 16, num_flatten_dims=2), size=16,
                              seq_len=seq_len)
    return main, startup, [h, c]


def _emb_fc_lstm(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = L.data("ids", shape=[7], dtype="int64")
        emb = L.embedding(ids, size=[30, 6])
        proj = L.fc(emb, 4 * 4, num_flatten_dims=2, bias_attr=False)
        h, c = L.dynamic_lstm(proj, size=4 * 4)
    return main, startup, [h]


def test_fc_gru_fuse_pass():
    pair = Pair(_fc_gru, _feed(x=((2, 5, 6), "float32", 0)))
    # no bias: fc_fuse_pass leaves the bare mul for fc_gru_fuse_pass
    pair.check(["fc_fuse_pass", "fc_gru_fuse_pass"], "_fc_gru_fused_count",
               1, tol=(1e-4, 1e-5))
    types = _types(pair.p_main)
    assert "fusion_gru" in types and "mul" not in types


def test_fc_lstm_fuse_pass():
    feed = _feed(x=((3, 5, 6), "float32", 0))
    feed["seq_len"] = np.array([5, 2, 0], "int64")
    pair = Pair(_fc_lstm, feed)
    pair.check(["fc_fuse_pass", "fc_lstm_fuse_pass"], "_fc_lstm_fused_count",
               1, tol=(1e-4, 1e-5))
    op = pair.p_main.global_block().ops[0]
    assert op.type == "fusion_lstm" and op.inputs["BiasX"]


def test_embedding_fc_lstm_fuse_pass():
    pair = Pair(_emb_fc_lstm, _feed(ids=((2, 7), "int64", 30)))
    pair.check(["embedding_fc_lstm_fuse_pass"], "_emb_fc_lstm_fused_count",
               1, tol=(1e-4, 1e-5))
    types = _types(pair.p_main)
    assert "fused_embedding_fc_lstm" in types
    assert "lookup_table" not in types and "mul" not in types


@pytest.mark.parametrize("build,name,counter", [
    (_fc_gru, "fc_gru_fuse_pass", "_fc_gru_fused_count"),
    (_fc_lstm, "fc_lstm_fuse_pass", "_fc_lstm_fused_count"),
    (_emb_fc_lstm, "embedding_fc_lstm_fuse_pass", "_emb_fc_lstm_fused_count")])
def test_recurrent_fusions_leave_training_programs_alone(build, name,
                                                         counter):
    """The grad ops read the projection too: no single-reader chain."""
    def train(pkg):
        main, startup, fetch = build(pkg)
        with pkg.program_guard(main, startup):
            loss = pkg.layers.mean(fetch[0])
            _mod(pkg, "optimizer").SGD(0.1).minimize(loss)
        return main, startup, [loss]

    pair = Pair(train, {})
    pair.check(["fc_fuse_pass", name], counter, 0, run=False)


# ---------------------------------------------------------------------------
# the conv and elementwise fusions
# ---------------------------------------------------------------------------
def _conv_bias_relu(reshaped):
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = L.data("x", shape=[3, 8, 8])
            if reshaped:
                c = L.conv2d(x, num_filters=4, filter_size=3, bias_attr=False)
                bias = L.create_parameter([4], "float32", name="cb")
                y = L.relu(L.elementwise_add(
                    c, L.reshape(bias, shape=[1, 4, 1, 1])))
            else:  # the layer's own [C] bias, fluid's axis=1 add, relu
                y = L.conv2d(x, num_filters=4, filter_size=3, act="relu")
        return main, startup, [y]
    return build


@pytest.mark.parametrize("reshaped", [True, False])
def test_conv_eltadd_relu_fuse_pass(reshaped):
    pair = Pair(_conv_bias_relu(reshaped), _feed(x=((2, 3, 8, 8), "float32",
                                                    0)))
    if reshaped:
        pair.put("cb", _RNG.randn(4).astype("float32"))
    pair.check(["conv_eltadd_relu_fuse_pass"], "_conv_eltadd_fused_count",
               1, tol=(1e-4, 1e-5))
    types = _types(pair.p_main)
    assert "relu" not in types and "elementwise_add" not in types
    conv = [op for op in pair.p_main.global_block().ops
            if op.type == "conv2d"][0]
    assert conv.attrs.get("fuse_relu") and conv.inputs.get("Bias")


def test_fuse_relu_into_conv_pass():
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = L.data("x", shape=[3, 8, 8])
            y = L.relu(L.conv2d(x, 4, 3, bias_attr=False))
        return main, startup, [y]

    pair = Pair(build, _feed(x=((2, 3, 8, 8), "float32", 0)))
    before = pair.run_port()
    pair.apply("fuse_relu_into_conv_pass")
    assert _types(pair.p_main) == ["conv2d"]
    np.testing.assert_allclose(pair.run_port()[0], before[0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
def test_fuse_elewise_add_act_pass(act):
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            a = L.data("a", shape=[6])
            b = L.data("b", shape=[6])
            y = getattr(L, act)(L.elementwise_add(a, b))
        return main, startup, [y]

    pair = Pair(build, _feed(a=((3, 6), "float32", 0),
                             b=((3, 6), "float32", 0)))
    pair.check(["fuse_elewise_add_act_pass"], "_elewise_act_fused_count", 1)
    assert _types(pair.p_main) == ["fused_elemwise_activation"]


def test_fuse_elewise_add_act_pass_protects_fetches():
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            a = L.data("a", shape=[6])
            s = L.elementwise_add(a, a)
            y = L.relu(s)
        main._protected_fetch_names = {s.name}
        return main, startup, [s, y]

    pair = Pair(build, _feed(a=((3, 6), "float32", 0)))
    pair.check(["fuse_elewise_add_act_pass"], "_elewise_act_fused_count", 0)


# ---------------------------------------------------------------------------
# batch-norm folding, is_test, train prune
# ---------------------------------------------------------------------------
def _bn_program(producer, form="plain"):
    """producer -> [scale ->] batch_norm -> relu, is_test (unless
    form == "train"); `form` also builds the refusals: two biases, a
    scale link with a bias, a protected producer output."""
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            if producer == "conv2d":
                x = L.data("x", shape=[3, 8, 8])
                h = L.conv2d(x, 4, 3, bias_attr=None if form == "two_biases"
                             else False)
            else:
                x = L.data("x", shape=[8])
                h = L.fc(x, 6)  # mul + bias add
            if form in ("scale", "scale_bias"):
                h = L.scale(h, scale=0.5,
                            bias=0.25 if form == "scale_bias" else 0.0)
            y = L.relu(L.batch_norm(h, is_test=form != "train"))
        if form == "two_biases":  # the conv's own Bias slot besides the add
            conv = main.global_block().ops[0]
            conv.inputs["Bias"] = [main.global_block().ops[1].inputs["Y"][0]]
        if form == "protected":
            main._protected_fetch_names = {h.name}
        return main, startup, [y]
    return build


def _bn_feed(producer):
    return _feed(x=(((2, 3, 8, 8) if producer == "conv2d" else (4, 8)),
                    "float32", 0))


def _seeded_stats(pair):
    block = pair.p_main.global_block()
    for op in block.ops:
        if op.type == "batch_norm":
            c = int(block.var(op.inputs["Scale"][0]).shape[0])
            for slot, v in (("Scale", _RNG.normal(1, 0.2, c)),
                            ("Bias", _RNG.normal(0, 0.2, c)),
                            ("Mean", _RNG.normal(0, 0.2, c)),
                            ("Variance", _RNG.uniform(0.5, 1.5, c))):
                pair.put(op.inputs[slot][0], v.astype("float32"))


@pytest.mark.parametrize("name", ["conv_bn_fuse_pass", "bn_fold_pass"])
@pytest.mark.parametrize("producer,form", [
    ("conv2d", "plain"), ("conv2d", "scale"), ("fc", "plain")])
def test_bn_fold_passes(name, producer, form):
    """The fold drops every batch_norm (and the scale link), the folded
    weights are bit-equal to the reference's, and the outputs stay
    within the reference's contract (rtol 1e-5 of the unfused)."""
    pair = Pair(_bn_program(producer, form), _bn_feed(producer))
    _seeded_stats(pair)
    before = pair.run_port()
    pair.apply(name, scope=True)
    types = _types(pair.p_main)
    assert "batch_norm" not in types and "scale" not in types
    for n in pair.p_scope.local_var_names():
        if n in pair.names or n.endswith("@BN_FOLDED_BIAS"):
            assert np.array_equal(pair.p_scope.find_var(n).numpy(),
                                  np.asarray(pair.r_scope.find_var(n))), n
    after = pair.run_port()
    np.testing.assert_allclose(after[0], before[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after[0], pair.run_ref()[0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("form", ["train", "two_biases", "scale_bias",
                                  "protected"])
def test_bn_fold_refusals_leave_the_chain(form):
    pair = Pair(_bn_program("conv2d", form), _bn_feed("conv2d"))
    pair.apply("bn_fold_pass", scope=True)
    assert "batch_norm" in _types(pair.p_main)
    for n in pair.names:  # nothing rewritten in the scope
        assert np.array_equal(pair.p_scope.find_var(n).numpy(),
                              np.asarray(pair.r_scope.find_var(n))), n


def test_bn_fold_pass_needs_a_scope():
    main, _, _ = _bn_program("conv2d")(ptt)
    with pytest.raises(ValueError, match="scope"):
        apply_pass(main, "bn_fold_pass")


def _dropout_mlp(impl, with_loss=False):
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = L.data("x", shape=[8])
            h = L.dropout(L.fc(x, 16, act="relu"), 0.3,
                          dropout_implementation=impl)
            pred = L.fc(h, 4, act="softmax")
            fetch = [pred]
            if with_loss:
                label = L.data("label", shape=[1], dtype="int64")
                loss = L.mean(L.cross_entropy(pred, label))
                _mod(pkg, "optimizer").SGD(0.1).minimize(loss)
                fetch = [loss]
        return main, startup, fetch
    return build


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_is_test_pass(impl):
    pair = Pair(_dropout_mlp(impl), _feed(x=((3, 8), "float32", 0)))
    for m in (pair.r_main, pair.p_main):
        for op in m.global_block().ops:
            if op.type == "dropout":
                op.attrs["is_test"] = True
    before = pair.run_port()
    pair.apply("is_test_pass")
    types = _types(pair.p_main)
    assert "dropout" not in types
    assert ("scale" in types) == (impl == "downgrade_in_infer")
    np.testing.assert_allclose(pair.run_port()[0], before[0], rtol=1e-5,
                               atol=1e-6)


def test_train_prune_pass():
    """On a training program's clone(for_test=True) with the prediction
    protected: the loss, its grads and the optimizer go."""
    def build(pkg):
        main, startup, _ = _dropout_mlp("downgrade_in_infer", True)(pkg)
        test = main.clone(for_test=True)
        pred = [op for op in test.global_block().ops
                if op.type == "softmax"][0].outputs["Out"][0]
        test._protected_fetch_names = {pred}
        return test, startup, [pred]

    pair = Pair(build, _feed(x=((3, 8), "float32", 0)))
    pair.apply("train_prune_pass")
    types = _types(pair.p_main)
    assert "sgd" not in types and "cross_entropy" not in types
    assert "dropout" not in types and types[-1] == "softmax"
    out = pair.run_port()[0]
    np.testing.assert_allclose(out, pair.run_ref()[0], rtol=1e-5, atol=1e-6)


def test_memory_optimize_pass_plan_matches_reference():
    def build(pkg):
        main, startup, fetch = _dropout_mlp("downgrade_in_infer")(pkg)
        main = main.clone(for_test=True)
        return main, startup, fetch

    pair = Pair(build, {})
    pair.apply("is_test_pass", "memory_optimize_pass")
    assert pair.p_main._memory_opt_plan == pair.r_main._memory_opt_plan
    assert pair.p_main._donate_vars == pair.r_main._donate_vars
    assert pair.p_main._memory_opt_plan["reuse"]
    from paddle_tpu.transpiler import release_memory as ref_release

    assert ptt.release_memory(pair.p_main) == ref_release(pair.r_main)


def test_nhwc_layout_pass():
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            img = pkg.layers.data("image", shape=[3, 16, 16])
            pred = _mod(pkg, "models.resnet").resnet_cifar10(img, 10, depth=8)
        return main, startup, [pred]

    pair = Pair(build, _feed(image=((2, 3, 16, 16), "float32", 0)))
    before = pair.run_port()
    pair.apply("nhwc_layout_pass")
    assert _types(pair.p_main).count("transpose2") == 2
    np.testing.assert_allclose(pair.run_port()[0], before[0], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# attention fusion: all four patterns
# ---------------------------------------------------------------------------
def _attention(bias, dropout, drop_is_test=True):
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            q = L.data("q", shape=[2, 8, 16])
            k = L.data("k", shape=[2, 8, 16])
            v = L.data("v", shape=[2, 8, 16])
            p = L.matmul(q, k, transpose_y=True, alpha=0.25)
            if bias:
                p = L.elementwise_add(p, L.data("bias", shape=[1, 1, 8]))
            w = L.softmax(p)
            if dropout:
                w = L.dropout(w, 0.1, is_test=drop_is_test)
            out = L.matmul(w, v)
        return main, startup, [out]
    return build


def _attention_feed():
    feed = _feed(q=((3, 2, 8, 16), "float32", 0),
                 k=((3, 2, 8, 16), "float32", 0),
                 v=((3, 2, 8, 16), "float32", 0))
    b = np.zeros((3, 1, 1, 8), "float32")
    b[..., -3:] = -1e9
    feed["bias"] = b
    return feed


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dropout", [True, False])
def test_attention_fuse_pass(bias, dropout):
    feed = _attention_feed()
    if not bias:
        feed.pop("bias")
    pair = Pair(_attention(bias, dropout), feed)
    pair.check(["attention_fuse_pass"], "_attention_fused_count", 1,
               tol=(1e-5, 1e-5))
    types = _types(pair.p_main)
    assert types == (["fused_attention", "scale"] if dropout
                     else ["fused_attention"])
    fused = pair.p_main.global_block().ops[0]
    assert ("Bias" in fused.inputs) == bias
    assert fused.outputs["Out"][0].endswith("@ATTN_RAW") == dropout


def test_attention_fuse_pass_refuses_a_training_dropout():
    pair = Pair(_attention(True, True, drop_is_test=False), {})
    pair.check(["attention_fuse_pass"], "_attention_fused_count", 0,
               run=False)
    assert "fused_attention" not in _types(pair.p_main)


# ---------------------------------------------------------------------------
# the sequence passes, on block.append_op programs
# ---------------------------------------------------------------------------
def _seqconv(bias_shape, relu=True):
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            b = main.global_block()
            x = pkg.layers.data("x", shape=[5, 6])
            filt = b.create_parameter(name="sc_w", shape=[18, 4],
                                      dtype="float32")
            bias = b.create_parameter(name="sc_b", shape=bias_shape,
                                      dtype="float32")
            sc = b.create_var(name="sc_out", shape=[-1, 5, 4],
                              dtype="float32")
            b.append_op("sequence_conv", inputs={"X": [x], "Filter": [filt]},
                        outputs={"Out": [sc]},
                        attrs={"contextLength": 3, "contextStart": -1,
                               "contextStride": 1})
            s = b.create_var(name="sc_sum", shape=[-1, 5, 4],
                             dtype="float32")
            b.append_op("elementwise_add", inputs={"X": [sc], "Y": [bias]},
                        outputs={"Out": [s]}, attrs={"axis": -1})
            y = b.create_var(name="sc_y", shape=[-1, 5, 4], dtype="float32")
            b.append_op("relu" if relu else "tanh", inputs={"X": [s]},
                        outputs={"Out": [y]})
        return main, startup, [y]
    return build


@pytest.mark.parametrize("bias_shape,relu,n", [([4], True, 1),
                                               ([5, 4], True, 0),
                                               ([4], False, 0)])
def test_seqconv_eltadd_relu_fuse_pass(bias_shape, relu, n):
    """IR only: fusion_seqconv_eltadd_relu's lowering waits with
    sequence_conv (ROADMAP A6c)."""
    pair = Pair(_seqconv(bias_shape, relu), {})
    pair.check(["seqconv_eltadd_relu_fuse_pass"], "_seqconv_fused_count", n,
               run=False)
    assert ("fusion_seqconv_eltadd_relu" in _types(pair.p_main)) == bool(n)


def _seqexpand(second_reader=False):
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            b = main.global_block()
            seq = L.data("seq", shape=[5, 12])
            vec = L.data("vec", shape=[6])
            exp = b.create_var(name="exp", shape=[-1, 5, 6], dtype="float32")
            b.append_op("sequence_expand", inputs={"X": [vec], "Y": [seq]},
                        outputs={"Out": [exp]})
            cat = L.concat([seq, exp], axis=2)
            out = L.fc(cat, 10, num_flatten_dims=2, act="relu")
            fetch = [out]
            if second_reader:
                fetch.append(L.reduce_sum(exp))
        return main, startup, fetch
    return build


@pytest.mark.parametrize("second_reader", [False, True])
def test_seqexpand_concat_fc_fuse_pass(second_reader):
    pair = Pair(_seqexpand(second_reader), {})
    pair.check(["fc_fuse_pass", "seqexpand_concat_fc_fuse_pass"],
               "_seqexpand_concat_fc_fused_count", 0 if second_reader else 1,
               run=False)
    types = _types(pair.p_main)
    if not second_reader:
        assert types == ["fusion_seqexpand_concat_fc"]
        op = pair.p_main.global_block().ops[0]
        assert op.attrs["fc_activation"] == "relu" and op.inputs["FCBias"]


# ---------------------------------------------------------------------------
# the new op lowerings against the reference's
# ---------------------------------------------------------------------------
_R = np.random.RandomState(22)
_F = lambda *s: (_R.randn(*s) * 0.5).astype("float32")  # noqa: E731
_LENS = np.array([6, 3, 0], "int64")

_CASES = {
    "gru": ("gru", {"Input": [_F(3, 6, 12)], "Weight": [_F(4, 12)],
                    "SeqLen": [_LENS]}, {}),
    "gru_reverse": ("gru", {"Input": [_F(3, 6, 12)], "Weight": [_F(4, 12)],
                            "H0": [_F(3, 4)]}, {"is_reverse": True}),
    "fusion_gru": ("fusion_gru", {"Input": [_F(3, 6, 5)],
                                  "WeightX": [_F(5, 12)],
                                  "BiasX": [_F(12)], "Weight": [_F(4, 12)],
                                  "SeqLen": [_LENS]}, {}),
    "lstm": ("lstm", {"Input": [_F(3, 6, 16)], "Weight": [_F(4, 16)],
                      "Bias": [_F(16)], "SeqLen": [_LENS]}, {}),
    "fusion_lstm": ("fusion_lstm", {"Input": [_F(3, 6, 5)],
                                    "WeightX": [_F(5, 16)],
                                    "BiasX": [_F(16)], "Weight": [_F(4, 16)],
                                    "Bias": [_F(16)], "H0": [_F(3, 4)],
                                    "C0": [_F(3, 4)]}, {}),
    "fusion_lstm_reverse": ("fusion_lstm", {
        "Input": [_F(3, 6, 5)], "WeightX": [_F(5, 16)],
        "Weight": [_F(4, 16)], "SeqLen": [_LENS]}, {"is_reverse": True}),
    "fused_embedding_fc_lstm": ("fused_embedding_fc_lstm", {
        "Ids": [_R.randint(0, 11, (3, 6, 1)).astype("int64")],
        "Embeddings": [_F(11, 5)], "WeightX": [_F(5, 16)],
        "BiasX": [_F(16)], "WeightH": [_F(4, 16)], "Bias": [_F(16)],
        "SeqLen": [_LENS]}, {}),
    "fused_elemwise_activation_unary_binary": (
        "fused_elemwise_activation", {"X": [_F(3, 7)], "Y": [_F(3, 7)]},
        {"functor_list": ["relu", "elementwise_add"]}),
    "fused_elemwise_activation_binary_unary": (
        "fused_elemwise_activation", {"X": [_F(3, 7)], "Y": [_F(3, 7)]},
        {"functor_list": ["elementwise_mul", "sigmoid"]}),
    "fused_elemwise_activation_scale": (
        "fused_elemwise_activation", {"X": [_F(3, 7)], "Y": [_F(3, 7)]},
        {"functor_list": ["elementwise_sub", "scale"], "scale": 0.3}),
    "fusion_seqexpand_concat_fc": (
        "fusion_seqexpand_concat_fc",
        {"X": [_F(3, 5, 4), _F(3, 2), _F(3, 3)], "FCWeight": [_F(9, 6)],
         "FCBias": [_F(6)]}, {"fc_activation": "tanh"}),
    "fusion_seqexpand_concat_fc_identity": (
        "fusion_seqexpand_concat_fc",
        {"X": [_F(3, 5, 4), _F(3, 2)], "FCWeight": [_F(6, 6)]}, {}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_new_lowering_matches_reference(case):
    op_type, ins, attrs = _CASES[case]
    _check(op_type, ins, attrs)


@pytest.mark.parametrize("op_type,kernel", [
    ("fusion_gru", "fused_gru"), ("fusion_lstm", "fused_lstm"),
    ("fused_embedding_fc_lstm", "fused_lstm")])
def test_fused_recurrent_ops_reach_the_kernel_wrappers(monkeypatch, op_type,
                                                       kernel):
    """The forward direction goes through padded_gru / padded_lstm's
    kernel wrapper (its kernel on CUDA tensors); the reverse does not."""
    from paddle_tpu_torch.core.registry import LowerCtx, get_op
    from paddle_tpu_torch.ops import nn_ops

    calls = []
    real = getattr(nn_ops, kernel)
    monkeypatch.setattr(nn_ops, kernel,
                        lambda *a: calls.append(a) or real(*a))
    case = {"fusion_gru": "fusion_gru", "fusion_lstm": "fusion_lstm",
            "fused_embedding_fc_lstm": "fused_embedding_fc_lstm"}[op_type]
    _, ins, attrs = _CASES[case]
    tins = {s: [torch.tensor(a) for a in v] for s, v in ins.items()}
    get_op(op_type).lower(LowerCtx(device="cpu"), tins, attrs)
    assert len(calls) == 1
    get_op(op_type).lower(LowerCtx(device="cpu"), tins,
                          dict(attrs, is_reverse=True))
    assert len(calls) == 1
