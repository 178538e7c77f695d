"""The port's conv nets on the CPU, against the reference.

- Each new lowering (conv2d, depthwise_conv2d, pool2d, adaptive_pool2d,
  batch_norm, sigmoid, momentum) on shared numpy inputs from a seed,
  and each differentiable one's ``<op>_grad`` (the port's
  ``lower_grad_op``, torch.func.vjp, against the reference's jax.vjp):
  rtol = atol = 1e-5 in float32 (summation order only); pool windows
  that lie wholly in padding compare with equal_nan.
- The programs op for op: ResNet-50 at 224 through
  ``build_resnet_train_program`` (build only), the CIFAR-10 ResNet at
  depth 8, SE-ResNeXt, VGG-16 and the MNIST CNN, each with and without
  ``rewrite_nhwc``, under Momentum and SGD.
- Five Momentum steps of resnet_cifar10(depth=8) at 32x32, batch 4,
  lr 0.01, from the reference's startup arrays, in NCHW and NHWC: the
  port's own five losses at rtol 1e-5; and each step run from the
  reference's state before it, its loss at rtol 1e-5 and every
  parameter, batch-norm running stat and velocity after it within 1e-5
  of the tensor's largest magnitude (an elementwise rtol would measure
  float32 noise on the elements near zero).  The state is held step by
  step because a relu input near 0 can change sign between two float32
  summation orders, and relu's derivative then moves a gradient element
  by its whole value (0.0 against 7.5e-4 at lr 0.03, step 4); at lr 0.1
  the reference's own NCHW and NHWC runs part that way (6.6e-4 of a
  velocity's magnitude at step 5).
- The builder's raises for the options not ported yet.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.registry import LowerCtx as RefCtx
from paddle_tpu.core.registry import lower_grad_op as ref_grad
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.core.registry import LowerCtx, get_op, lower_grad_op
from paddle_tpu_torch.io import params_from_numpy

from test_torch_ops import _grad_attrs, _run_both
from test_torch_program import _assert_same_program

TOL = dict(rtol=1e-5, atol=1e-5)


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


_R = np.random.RandomState(18)
_F = lambda *s: _R.randn(*s).astype("float32")  # noqa: E731


def _conv(**kw):
    attrs = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
             "groups": 1}
    attrs.update(kw)
    return attrs


def _pool(**kw):
    attrs = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
             "paddings": [0, 0], "global_pooling": False, "ceil_mode": False,
             "exclusive": True}
    attrs.update(kw)
    return attrs


def _bn(**kw):
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": "NCHW", "use_global_stats": False}
    attrs.update(kw)
    return attrs


def _bn_ins(x, c):
    return {"X": [x], "Scale": [_F(c)], "Bias": [_F(c)], "Mean": [_F(c)],
            "Variance": [np.abs(_F(c)) + 0.5]}


# op type, inputs, attrs
_CASES = {
    "conv2d": ("conv2d", {"Input": [_F(2, 3, 9, 9)],
                          "Filter": [_F(4, 3, 3, 3)]},
               _conv(paddings=[1, 1])),
    "conv2d_stride_pad_dilation": (
        "conv2d", {"Input": [_F(2, 3, 11, 10)], "Filter": [_F(4, 3, 3, 2)]},
        _conv(strides=[2, 1], paddings=[1, 2], dilations=[2, 1])),
    "conv2d_groups": ("conv2d", {"Input": [_F(2, 4, 7, 7)],
                                 "Filter": [_F(6, 2, 3, 3)]},
                      _conv(paddings=[1, 1], groups=2)),
    "conv2d_bias_fuse_relu": ("conv2d", {"Input": [_F(2, 3, 8, 8)],
                                         "Filter": [_F(5, 3, 3, 3)],
                                         "Bias": [_F(5)]},
                              _conv(strides=[2, 2], fuse_relu=True)),
    "conv2d_nhwc": ("conv2d", {"Input": [_F(2, 9, 8, 3)],
                               "Filter": [_F(4, 3, 3, 3)], "Bias": [_F(4)]},
                    _conv(strides=[2, 2], paddings=[1, 1],
                          data_format="NHWC")),
    "conv2d_nhwc_groups": ("conv2d", {"Input": [_F(2, 7, 7, 4)],
                                      "Filter": [_F(4, 2, 3, 3)]},
                           _conv(groups=2, data_format="NHWC")),
    "depthwise_conv2d": ("depthwise_conv2d", {"Input": [_F(2, 3, 8, 8)],
                                              "Filter": [_F(3, 1, 3, 3)]},
                         _conv(paddings=[1, 1], groups=3)),
    "depthwise_conv2d_nhwc_bias": (
        "depthwise_conv2d", {"Input": [_F(2, 8, 8, 3)],
                             "Filter": [_F(6, 1, 3, 3)], "Bias": [_F(6)]},
        _conv(strides=[2, 2], data_format="NHWC")),
    "pool2d_max": ("pool2d", {"X": [_F(2, 3, 9, 9)]},
                   _pool(ksize=[3, 3], strides=[2, 2], paddings=[1, 1])),
    "pool2d_max_nhwc": ("pool2d", {"X": [_F(2, 9, 9, 3)]},
                        _pool(ksize=[3, 3], paddings=[1, 1],
                              data_format="NHWC")),
    "pool2d_avg": ("pool2d", {"X": [_F(2, 3, 8, 8)]},
                   _pool(pooling_type="avg")),
    "pool2d_avg_exclusive_pad": ("pool2d", {"X": [_F(2, 3, 7, 7)]},
                                 _pool(pooling_type="avg", ksize=[3, 3],
                                       paddings=[1, 1])),
    "pool2d_avg_inclusive_pad": ("pool2d", {"X": [_F(2, 3, 7, 7)]},
                                 _pool(pooling_type="avg", ksize=[3, 3],
                                       paddings=[1, 1], exclusive=False)),
    "pool2d_avg_exclusive_nhwc": ("pool2d", {"X": [_F(2, 7, 6, 3)]},
                                  _pool(pooling_type="avg", ksize=[3, 3],
                                        paddings=[1, 1], strides=[1, 2],
                                        data_format="NHWC")),
    "pool2d_max_ceil": ("pool2d", {"X": [_F(2, 3, 8, 8)]},
                        _pool(ksize=[3, 3], ceil_mode=True)),
    "pool2d_avg_ceil_exclusive": ("pool2d", {"X": [_F(2, 3, 8, 7)]},
                                  _pool(pooling_type="avg", ksize=[3, 3],
                                        paddings=[1, 0], ceil_mode=True)),
    # H, W 5 at k 2, s 4, pad 1: ceil_mode pads 3 more on the right, and
    # the last window lies wholly in padding (-inf max, NaN exclusive avg)
    "pool2d_max_ceil_window_in_padding": (
        "pool2d", {"X": [_F(2, 3, 5, 5)]},
        _pool(strides=[4, 4], paddings=[1, 1], ceil_mode=True)),
    "pool2d_avg_ceil_window_in_padding": (
        "pool2d", {"X": [_F(2, 3, 5, 5)]},
        _pool(pooling_type="avg", strides=[4, 4], paddings=[1, 1],
              ceil_mode=True)),
    "pool2d_avg_ceil_window_in_padding_inclusive": (
        "pool2d", {"X": [_F(2, 3, 5, 5)]},
        _pool(pooling_type="avg", strides=[4, 4], paddings=[1, 1],
              ceil_mode=True, exclusive=False)),
    "pool2d_global_max": ("pool2d", {"X": [_F(2, 3, 5, 4)]},
                          _pool(ksize=[-1, -1], global_pooling=True)),
    "pool2d_global_avg": ("pool2d", {"X": [_F(2, 3, 5, 4)]},
                          _pool(pooling_type="avg", ksize=[7, 7],
                                global_pooling=True)),
    "pool2d_global_avg_nhwc": ("pool2d", {"X": [_F(2, 5, 4, 3)]},
                               _pool(pooling_type="avg",
                                     global_pooling=True,
                                     data_format="NHWC")),
    "adaptive_pool2d_avg": ("adaptive_pool2d", {"X": [_F(2, 3, 8, 6)]},
                            {"ksize": [4, 3], "pooling_type": "avg"}),
    "adaptive_pool2d_max": ("adaptive_pool2d", {"X": [_F(2, 3, 8, 6)]},
                            {"ksize": [2, 2], "pooling_type": "max"}),
    "batch_norm": ("batch_norm", _bn_ins(_F(4, 3, 5, 5), 3), _bn()),
    "batch_norm_nhwc": ("batch_norm", _bn_ins(_F(4, 5, 5, 3), 3),
                        _bn(data_layout="NHWC", momentum=0.8, epsilon=1e-3)),
    "batch_norm_2d": ("batch_norm", _bn_ins(_F(6, 4), 4), _bn()),
    "batch_norm_2d_nhwc": ("batch_norm", _bn_ins(_F(6, 4), 4),
                           _bn(data_layout="NHWC")),
    "batch_norm_is_test": ("batch_norm", _bn_ins(_F(4, 3, 5, 5), 3),
                           _bn(is_test=True)),
    "batch_norm_is_test_nhwc": ("batch_norm", _bn_ins(_F(4, 5, 5, 3), 3),
                                _bn(is_test=True, data_layout="NHWC")),
    "batch_norm_use_global_stats": ("batch_norm",
                                    _bn_ins(_F(4, 3, 5, 5), 3),
                                    _bn(use_global_stats=True)),
    "sigmoid": ("sigmoid", {"X": [_F(4, 7)]}, {}),
}

_MOMENTUM = {
    "momentum": {"mu": 0.9, "use_nesterov": False},
    "momentum_nesterov": {"mu": 0.8, "use_nesterov": True},
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lowering_matches_reference(case):
    """Every output slot (batch_norm's five: Y, MeanOut, VarianceOut,
    SavedMean, SavedVariance) against the reference's."""
    op_type, ins, attrs = _CASES[case]
    ref, out = _run_both(op_type, ins, attrs)
    assert set(out) == set(ref), (case, set(out), set(ref))
    for slot in ref:
        for a, b in zip(ref[slot], out[slot]):
            assert a.shape == b.shape, (case, slot, a.shape, b.shape)
            np.testing.assert_allclose(b, a, equal_nan=True, err_msg=slot,
                                       **TOL)


def test_windows_in_padding_and_global_ties():
    """The cases above reach what PyTorch's own options would not: with
    ceil_mode a window wholly in padding gives -inf (max) and NaN
    (exclusive avg), and global max pooling splits the gradient of a
    tie evenly, as jnp.max's vjp does."""
    _, ins, attrs = _CASES["pool2d_max_ceil_window_in_padding"]
    _, out = _run_both("pool2d", ins, attrs)
    assert out["Out"][0].shape == (2, 3, 3, 3)
    assert np.isneginf(out["Out"][0][:, :, 2, :]).all()
    assert np.isfinite(out["Out"][0][:, :, :2, :2]).all()
    _, ins, attrs = _CASES["pool2d_avg_ceil_window_in_padding"]
    _, out = _run_both("pool2d", ins, attrs)
    assert np.isnan(out["Out"][0][:, :, 2, :]).all()
    x = np.zeros((1, 1, 2, 2), "float32")
    x[0, 0, 0, 1] = x[0, 0, 1, 0] = 1.0
    g = lower_grad_op(LowerCtx(device="cpu"),
                      {"X": [torch.tensor(x)],
                       "Out@GRAD": [torch.ones(1, 1, 1, 1)]},
                      _grad_attrs("pool2d", _CASES["pool2d_global_max"][2],
                                  {"X": None}, ["Out"]))
    np.testing.assert_array_equal(g["X@GRAD"][0].numpy()[0, 0],
                                  [[0.0, 0.5], [0.5, 0.0]])


@pytest.mark.parametrize("case", sorted(_MOMENTUM))
def test_momentum_matches_reference(case):
    ins = {"Param": [_F(5, 3)], "Grad": [_F(5, 3)], "Velocity": [_F(5, 3)],
           "LearningRate": [np.array([0.1], "float32")]}
    ref, out = _run_both("momentum", ins, _MOMENTUM[case])
    assert set(out) == set(ref) == {"ParamOut", "VelocityOut"}
    for slot in ref:
        np.testing.assert_allclose(out[slot][0], ref[slot][0], **TOL)


_GRAD_CASES = sorted(c for c in _CASES
                     if "window_in_padding" not in c)


@pytest.mark.parametrize("case", _GRAD_CASES)
def test_grad_lowering_matches_reference(case):
    """<op>_grad through torch.func.vjp against jax.vjp, with the same
    random cotangents for every float output but batch_norm's SavedMean.
    That output no op reads; the reference leaves it differentiable, the
    port detaches it with the other statistics, so that the step's vjp
    does no work for it.  MeanOut, VarianceOut and SavedVariance get a
    cotangent, which both packages must stop."""
    import jax.numpy as jnp

    op_type, ins, attrs = _CASES[case]
    fwd, _ = _run_both(op_type, ins, attrs)
    out_slots = list(fwd)
    cots = {s + "@GRAD": [_F(*a.shape) for a in fwd[s]]
            for s in out_slots if s != "SavedMean"}
    gattrs = _grad_attrs(op_type, attrs, ins, out_slots)
    gins = dict(ins, **cots)
    ref = ref_grad(RefCtx(), None,
                   {s: [jnp.asarray(a) for a in v] for s, v in gins.items()},
                   gattrs)
    out = lower_grad_op(LowerCtx(device="cpu"),
                        {s: [torch.tensor(np.asarray(a)) for a in v]
                         for s, v in gins.items()}, gattrs)
    assert set(out) == set(ref), (case, set(out), set(ref))
    for slot in ref:
        for a, b in zip(ref[slot], out[slot]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       err_msg=slot, **TOL)


def test_grad_lowerings_with_windows_in_padding():
    """The ceil_mode windows wholly in padding: their cotangent reaches
    no input element, in either package (the max picks a pad, the avg
    spreads over pads)."""
    import jax.numpy as jnp

    for case in ("pool2d_max_ceil_window_in_padding",
                 "pool2d_avg_ceil_window_in_padding_inclusive"):
        op_type, ins, attrs = _CASES[case]
        cot = {"Out@GRAD": [_F(2, 3, 3, 3)]}
        gattrs = _grad_attrs(op_type, attrs, ins, ["Out"])
        gins = dict(ins, **cot)
        ref = ref_grad(RefCtx(), None, {s: [jnp.asarray(a) for a in v]
                                        for s, v in gins.items()}, gattrs)
        out = lower_grad_op(LowerCtx(device="cpu"),
                            {s: [torch.tensor(a) for a in v]
                             for s, v in gins.items()}, gattrs)
        np.testing.assert_allclose(out["X@GRAD"][0].numpy(),
                                   np.asarray(ref["X@GRAD"][0]), **TOL)


def test_conv_rules_run_under_deterministic_cudnn(monkeypatch):
    """The conv lowerings and their vjp's backward run with cuDNN's
    deterministic algorithms and no autotuning (a CUDA-graph capture
    cannot hold it), and leave the process's settings as they were;
    TF32 is left as the process set it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import nn_ops

    seen = []
    real = F.conv2d

    def spy(*a, **k):
        cudnn = torch.backends.cudnn
        seen.append((cudnn.benchmark, cudnn.deterministic))
        return real(*a, **k)

    monkeypatch.setattr(nn_ops.F, "conv2d", spy)
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = True
    try:
        op_type, ins, attrs = _CASES["conv2d"]
        tins = {s: [torch.tensor(a) for a in v] for s, v in ins.items()}
        get_op(op_type).lower(LowerCtx(device="cpu"), tins, attrs)
        g = lower_grad_op(
            LowerCtx(device="cpu"),
            dict(tins, **{"Output@GRAD": [torch.ones(2, 4, 9, 9)]}),
            _grad_attrs(op_type, attrs, ins, ["Output"]))
        assert set(g) == {"Input@GRAD", "Filter@GRAD"}
        assert seen and all(s == (False, True) for s in seen), seen
        assert torch.backends.cudnn.benchmark is True
        assert torch.backends.cudnn.deterministic is saved[1]
    finally:
        torch.backends.cudnn.benchmark = saved[0]
        torch.backends.cudnn.deterministic = saved[1]


def test_ops_infer_shapes_on_meta_tensors_with_the_batch_unknown():
    """Build-time shape inference runs each lowering on meta tensors with
    the -1 batch (the pooling's count tensor, the cuDNN settings
    included)."""
    from paddle_tpu_torch import layers

    img = layers.data("img", shape=[3, 9, 9])
    c = layers.conv2d(img, 4, 3, padding=1, act="relu")
    assert tuple(c.shape) == (-1, 4, 9, 9)
    p = layers.pool2d(c, 3, "avg", 2, 1, ceil_mode=True)
    assert tuple(p.shape) == (-1, 4, 5, 5)
    b = layers.batch_norm(p)
    assert tuple(b.shape) == (-1, 4, 5, 5)
    g = layers.pool2d(b, pool_type="max", global_pooling=True)
    assert tuple(g.shape) == (-1, 4, 1, 1)
    a = layers.adaptive_pool2d(b, [1, 5], pool_type="avg")
    assert tuple(a.shape) == (-1, 4, 1, 5)
    d = layers.depthwise_conv2d(b, 8, 3, stride=2)
    assert tuple(d.shape) == (-1, 8, 2, 2)


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------
def _cnn_program(pkg, net, image_shape, class_dim, use_nhwc, optimizer,
                 lr=0.1):
    """data -> net -> cross_entropy -> mean (+ accuracy), optionally
    rewritten to NHWC, then the optimizer, in `pkg` (paddle_tpu or
    paddle_tpu_torch): the same calls in both packages."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("image", shape=list(image_shape))
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        predict = net(img, class_dim)
        avg = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        acc = pkg.layers.accuracy(predict, label)
        if use_nhwc:
            _mod(pkg, "transpiler.layout_transpiler").rewrite_nhwc(main)
        opt = _mod(pkg, "optimizer")
        (opt.Momentum(learning_rate=lr, momentum=0.9) if optimizer ==
         "momentum" else opt.SGD(learning_rate=lr)).minimize(avg)
    return main, startup, [avg, acc]


def _mod(pkg, name):
    """The module `name` of `pkg`."""
    return importlib.import_module(pkg.__name__ + "." + name)


def _nets(pkg):
    """Each net's builder in `pkg`, its image shape and class count (the
    SE-ResNeXt narrowed to two stages of one block, cardinality 8)."""
    m = lambda n: _mod(pkg, "models." + n)  # noqa: E731
    return {
        "resnet_cifar10_8": (lambda x, c: m("resnet").resnet_cifar10(
            x, c, depth=8), (3, 32, 32), 10),
        "se_resnext": (lambda x, c: m("se_resnext").se_resnext(
            x, c, stages=[1, 1], num_filters=[32, 64], cardinality=8,
            reduction_ratio=4), (3, 32, 32), 10),
        "vgg16": (lambda x, c: m("vgg").vgg16(x, c), (3, 32, 32), 10),
        "mnist_cnn": (lambda x, c: m("mnist").cnn_model(x, c), (1, 28, 28),
                      10),
    }


@pytest.mark.parametrize("use_nhwc", [False, True])
def test_resnet50_train_program_matches_reference(use_nhwc):
    """build_resnet_train_program at 224, ResNet-50, Momentum: the main
    and startup programs op for op (the NHWC form's transposes and
    @NHWC aliases included), the feeds and fetches."""
    from paddle_tpu.models import resnet as ref_resnet
    from paddle_tpu_torch.models import resnet as port_resnet

    r_main, r_start, r_feeds, r_fetch = \
        ref_resnet.build_resnet_train_program(use_nhwc=use_nhwc)
    p_main, p_start, p_feeds, p_fetch = \
        port_resnet.build_resnet_train_program(use_nhwc=use_nhwc)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    assert p_feeds == r_feeds == ["image", "label"]
    assert [v.name for v in p_fetch] == [v.name for v in r_fetch]
    types = [o.type for o in p_main.global_block().ops]
    assert types.count("conv2d") == types.count("conv2d_grad") == 53
    assert types.count("batch_norm") == 53
    assert types.count("momentum") == 161  # 53 convs, 53 x 2 BN, fc w, b
    assert types.count("transpose2") == (2 if use_nhwc else 0)
    convs = [o for o in p_main.global_block().ops if o.type == "conv2d"]
    assert all(o.attrs.get("data_format", "NCHW") == (
        "NHWC" if use_nhwc else "NCHW") for o in convs)


@pytest.mark.parametrize("optimizer", ["momentum", "sgd"])
@pytest.mark.parametrize("use_nhwc", [False, True])
@pytest.mark.parametrize("net", ["resnet_cifar10_8", "se_resnext", "vgg16",
                                 "mnist_cnn"])
def test_cnn_programs_match_reference(net, use_nhwc, optimizer):
    r_net, shape, classes = _nets(fluid)[net]
    p_net = _nets(ptt)[net][0]
    r_main, r_start, r_fetch = _cnn_program(fluid, r_net, shape, classes,
                                            use_nhwc, optimizer)
    p_main, p_start, p_fetch = _cnn_program(ptt, p_net, shape, classes,
                                            use_nhwc, optimizer)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    assert [v.name for v in p_fetch] == [v.name for v in r_fetch]
    types = {o.type for o in p_main.global_block().ops}
    assert optimizer in types


def test_resnet_builder_raises_for_options_not_ported():
    from paddle_tpu_torch.models import resnet

    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        resnet.build_resnet_train_program(use_bf16=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        resnet.build_resnet_train_program(use_reader_op=True)


def test_rewrite_nhwc_refuses_sub_blocks():
    """The reference keeps NCHW copies of the vars its sub-block ops
    read; the port has no control flow yet, so it refuses them."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.transpiler.layout_transpiler import rewrite_nhwc

    main = framework.Program()
    with framework.program_guard(main, framework.Program()):
        img = layers.data("image", shape=[3, 8, 8])
        layers.conv2d(img, 4, 3)
    main.global_block().ops[0].attrs["sub_block"] = 1
    with pytest.raises(NotImplementedError, match="ROADMAP A6c"):
        rewrite_nhwc(main)


# ---------------------------------------------------------------------------
# training against the reference
# ---------------------------------------------------------------------------
CIFAR_BATCH, CIFAR_STEPS, LR = 4, 5, 0.01


def _cifar_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(CIFAR_BATCH, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (CIFAR_BATCH, 1)).astype("int64")}


def _train_reference(use_nhwc, batch):
    """The reference's five steps from its startup state: the losses and
    the persistable state before the first step and after each."""
    net = _nets(fluid)["resnet_cifar10_8"][0]
    main, start, fetch = _cnn_program(fluid, net, (3, 32, 32), 10, use_nhwc,
                                      "momentum", lr=LR)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(start)
        names = [n for n, v in main.global_block().vars.items()
                 if v.persistable]
        states = [{n: np.asarray(scope.find_var(n)) for n in names}]
        losses = []
        for _ in range(CIFAR_STEPS):
            losses.append(float(np.asarray(exe.run(
                main, feed=batch, fetch_list=[fetch[0]])[0]).sum()))
            states.append({n: np.asarray(scope.find_var(n)) for n in names})
    return losses, states


@pytest.mark.parametrize("use_nhwc", [False, True])
def test_resnet_cifar10_momentum_steps_match_reference(use_nhwc):
    """resnet_cifar10(depth=8), batch 4 at 32x32, Momentum 0.9 at lr
    0.01, from the reference's startup arrays carried over as numpy (the
    batch-norm running stats and the zero velocities too).  The port's
    own five steps give the reference's losses.  Each step also runs
    from the reference's state before it, and leaves the reference's
    state after it: every parameter, running stat and velocity.  So the
    state is held step by step, without the float32 noise of the earlier
    steps, which at larger rates flips the sign of a batch-norm output
    near 0 under relu (see the module's docstring)."""
    batch = _cifar_batch()
    r_losses, states = _train_reference(use_nhwc, batch)
    net = _nets(ptt)["resnet_cifar10_8"][0]
    main, _, fetch = _cnn_program(ptt, net, (3, 32, 32), 10, use_nhwc,
                                  "momentum", lr=LR)
    exe = ptt.Executor(ptt.CPUPlace())

    def step(scope):
        return float(exe.run(main, feed=batch, fetch_list=[fetch[0]],
                             scope=scope)[0].sum())

    scope = ptt.Scope()
    params_from_numpy(states[0], scope, ptt.CPUPlace())
    losses = [step(scope) for _ in range(CIFAR_STEPS)]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    assert len(set(losses)) == CIFAR_STEPS  # the parameters moved

    n_bn = [o.type for o in main.global_block().ops].count("batch_norm")
    n_params = len(main.global_block().all_parameters()) - 2 * n_bn
    for k in range(CIFAR_STEPS):
        scope = ptt.Scope()
        params_from_numpy(states[k], scope, ptt.CPUPlace())
        np.testing.assert_allclose(step(scope), r_losses[k], rtol=1e-5)
        kinds = {"velocity": 0, "running stat": 0, "parameter": 0}
        for name, want in states[k + 1].items():
            got = scope.find_var(name).numpy()
            assert got.shape == want.shape, name
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= 1e-5 * scale, (k, name)
            if not np.array_equal(want, states[k][name]):
                kind = ("velocity" if "velocity" in name else "running stat"
                        if name.endswith((".w_1", ".w_2")) else "parameter")
                kinds[kind] += 1
        # every parameter and its velocity moved, and each BN's two
        # running stats
        assert kinds == {"velocity": n_params, "parameter": n_params,
                         "running stat": 2 * n_bn}, (k, kinds)
    assert n_bn == 9
