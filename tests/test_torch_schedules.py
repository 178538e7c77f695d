"""A1's leftovers in the port, each built through both packages: the
learning-rate schedules (``layers/learning_rate_scheduler.py``) and
``append_LARS``, the rest of the activation table and its generated
unary layers (``ops/math_ops.py``, ``layers/ops.py``), the initializers
(``TruncatedNormal``, ``MSRA``, ``Bilinear``, the ``truncated_gaussian_random``
op), ``WeightNormParamAttr``, ``name_scope``, ``cpu_places``, the
``LayerHelper`` members, the places choice and the top-level names.

Tolerances: a schedule's learning rate within 1e-6 relative over 10
runs (float32 scalar arithmetic in the same order); LARS's rates and the
activations' values and grads at rtol = atol = 1e-5 (float32
reductions and transcendentals); Bilinear's values exact.  Random
draws cannot match the reference's threefry stream: TruncatedNormal's
samples are held to [mean - 2 std, mean + 2 std] and to the truncated
distribution's mean and std within 5 standard errors."""

import inspect
import json
import math

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.registry import LowerCtx as RefCtx
from paddle_tpu.core.registry import get_op as ref_op
from paddle_tpu.core.registry import lower_grad_op as ref_grad
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.core.registry import LowerCtx, get_op, lower_grad_op
from paddle_tpu_torch.layer_helper import LayerHelper

STEPS = 10


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


def _same_ops(ref, port):
    """Both programs' ops equal through to_json."""
    r = json.loads(ref.to_json())["blocks"][0]["ops"]
    p = json.loads(port.to_json())["blocks"][0]["ops"]
    assert len(p) == len(r)
    for i, (a, b) in enumerate(zip(r, p)):
        assert b == a, "op %d differs:\nref  %s\nport %s" % (i, a, b)


def _build(pkg, fn):
    """(main, startup, fn's result) built by one package in fresh
    programs under a fresh name generator."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = fn(pkg)
    return main, startup, out


def _run(pkg, place, main, startup, fetch, steps, feed=None):
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(place)
        exe.run(startup)
        return [[np.asarray(v) for v in exe.run(main, feed=feed or {},
                                                fetch_list=fetch)]
                for _ in range(steps)]


def _both(fn, steps=STEPS, feed=None):
    """fn built and run `steps` times by each package: ({"ref", "port"}
    programs, {"ref", "port"} fetched values per run)."""
    progs, runs = {}, {}
    for key, pkg, place in (("ref", fluid, fluid.CPUPlace()),
                            ("port", ptt, ptt.CPUPlace())):
        main, startup, out = _build(pkg, fn)
        fetch = out if isinstance(out, list) else [out]
        progs[key] = (main, startup)
        runs[key] = _run(pkg, place, main, startup, fetch, steps, feed)
    return progs, runs


# ---------------------------------------------------------------------------
# 1. the learning-rate schedules
# ---------------------------------------------------------------------------
SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.7),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 2, 0.7, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 6, 0.001, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 4, 0.001,
                                                     power=1.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 5, 7],
                                             [0.1, 0.05, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 4, 0.0, 0.1),
    "linear_warmup_of_exponential": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.1, 3, 0.5), 5, 0.01, 0.08),
    "noam": lambda L: L.noam_decay(64, 4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    """The schedule's main and startup programs op for op (every op
    carrying the lrsched role), and its rate over 10 runs within 1e-6
    relative; the rates change over the runs."""
    progs, runs = _both(lambda pkg: SCHEDULES[name](pkg.layers))
    for i in (0, 1):
        _same_ops(progs["ref"][i], progs["port"][i])
    ops = progs["port"][0].global_block().ops
    assert ops and all(op.attrs.get("op_role") == "lrsched" for op in ops), [
        (op.type, op.attrs.get("op_role")) for op in ops]
    want = np.array([r[0] for r in runs["ref"]]).reshape(-1)
    got = np.array([r[0] for r in runs["port"]]).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(set(want.tolist())) > 1


def _lars_program(pkg):
    """A narrow fc regression whose parameters' rates are LARS's."""
    x = pkg.layers.data("x", shape=[8])
    y = pkg.layers.data("y", shape=[3])
    pred = pkg.layers.fc(x, size=3)
    loss = pkg.layers.mean(pkg.layers.square(pred - y))
    params_grads = pkg.backward.append_backward(loss)
    return pkg.layers.append_LARS(params_grads, 0.1, 5e-4)


def test_append_lars_matches_reference():
    """append_LARS's ops op for op and its per-parameter rates (written
    into optimize_attr) from the same weights."""
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(4, 8).astype("float32"),
            "y": rng.randn(4, 3).astype("float32")}
    progs, vals = {}, {}
    for key, pkg, place in (("ref", fluid, fluid.CPUPlace()),
                            ("port", ptt, ptt.CPUPlace())):
        main, startup, lrs = _build(pkg, _lars_program)
        assert len(lrs) == 2
        block = main.global_block()
        assert [p.optimize_attr["learning_rate"].name
                for p in block.all_parameters()] == [v.name for v in lrs]
        progs[key] = (main, startup)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(place)
            exe.run(startup)
            if key == "ref":
                init = {p.name: np.asarray(scope.find_var(p.name))
                        for p in block.all_parameters()}
            else:
                for n, v in init.items():
                    scope.set(n, torch.from_numpy(v.copy()))
            vals[key] = [np.asarray(v) for v in exe.run(main, feed=feed,
                                                         fetch_list=lrs)]
    _same_ops(progs["ref"][0], progs["port"][0])
    for a, b in zip(vals["ref"], vals["port"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 2. the activation table and the unary layers
# ---------------------------------------------------------------------------
_R = np.random.RandomState(7)


def _x(lo=-3.0, hi=3.0, shape=(4, 9)):
    return _R.uniform(lo, hi, shape).astype("float32")


# (op, X, attrs): values away from the kinks, where the reference's and
# the port's derivatives agree by definition
ACTS = {
    "rsqrt": (_x(0.5, 4.0), {}),
    "abs": (_x(), {}),
    "ceil": (_x(), {}),
    "floor": (_x(), {}),
    "round": (_x(), {}),
    "cos": (_x(), {}),
    "sin": (_x(), {}),
    "exp": (_x(), {}),
    "reciprocal": (_x(0.5, 4.0), {}),
    "softplus": (_x(), {}),
    "softsign": (_x(), {}),
    "relu6": (_x(-2.0, 8.0), {"threshold": 5.0}),
    "leaky_relu": (_x(), {"alpha": 0.1}),
    "elu": (_x(), {"alpha": 0.7}),
    "hard_sigmoid": (_x(), {"slope": 0.3, "offset": 0.4}),
    "brelu": (_x(-5.0, 30.0), {"t_min": 1.0, "t_max": 20.0}),
    "soft_relu": (_x(-50.0, 50.0), {"threshold": 20.0}),
    "stanh": (_x(), {"scale_a": 0.5, "scale_b": 1.5}),
    "thresholded_relu": (_x(), {"threshold": 0.5}),
    "hard_shrink": (_x(), {"threshold": 0.4}),
    "tanh_shrink": (_x(), {}),
    "logsigmoid": (_x(), {}),
    "erf": (_x(), {}),
    "selu": (_x(), {}),
    "elu_default": (_x(), {}),
    "soft_relu_default": (_x(-50.0, 50.0), {}),
}


def _op(case):
    return case.split("_default")[0]


@pytest.mark.parametrize("case", sorted(ACTS))
def test_activation_matches_reference(case):
    """The lowering's value against the reference's on the same input."""
    import jax.numpy as jnp

    x, attrs = ACTS[case]
    want = ref_op(_op(case)).lower(RefCtx(), {"X": [jnp.asarray(x)]}, attrs)
    got = get_op(_op(case)).lower(LowerCtx(device="cpu"),
                                  {"X": [torch.from_numpy(x)]}, attrs)
    np.testing.assert_allclose(got["Out"][0].numpy(),
                               np.asarray(want["Out"][0]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(ACTS))
def test_activation_grad_matches_reference(case):
    """<op>_grad through the port's lower_grad_op (torch.func.vjp of the
    forward rule) against the reference's (jax.vjp), same cotangent."""
    import jax.numpy as jnp

    x, attrs = ACTS[case]
    dy = _R.randn(*x.shape).astype("float32")
    gattrs = {"__fwd_type__": _op(case), "__fwd_attrs__": dict(attrs),
              "__fwd_in_slots__": ["X"], "__fwd_out_slots__": ["Out"],
              "__fwd_out_names__": {"Out": ["out"]}, "__fwd_op_idx__": 3}
    want = ref_grad(RefCtx(), None, {"X": [jnp.asarray(x)],
                                     "Out@GRAD": [jnp.asarray(dy)]}, gattrs)
    got = lower_grad_op(LowerCtx(device="cpu"),
                        {"X": [torch.from_numpy(x)],
                         "Out@GRAD": [torch.from_numpy(dy)]}, gattrs)
    assert set(got) == set(want) == {"X@GRAD"}
    np.testing.assert_allclose(got["X@GRAD"][0].numpy(),
                               np.asarray(want["X@GRAD"][0]), rtol=1e-5,
                               atol=1e-5)


def test_unary_layers_match_reference():
    """Every generated unary layer (the six of layers/nn.py with
    **kwargs among them) appends the reference's op with the caller's
    kwargs as attrs, and the program runs to the reference's values."""
    from paddle_tpu.layers import ops as ref_ops

    from paddle_tpu_torch.layers import ops as port_ops

    assert port_ops.__all__ == ref_ops.__all__
    kwargs = {"brelu": {"t_min": 0.5, "t_max": 2.0}, "stanh": {"scale_a": 0.5},
              "soft_relu": {"threshold": 3.0}, "gelu": {"approximate": True},
              "hard_shrink": {"threshold": 0.2}, "sqrt": {}}

    def build(pkg):
        x = pkg.layers.data("x", shape=[6])
        pos = pkg.layers.abs(x) + 0.5
        outs = []
        for name in pkg.layers.ops.__all__:
            arg = pos if name in ("sqrt", "rsqrt", "log", "reciprocal") else x
            outs.append(getattr(pkg.layers, name)(arg, **kwargs.get(name, {})))
        return outs

    feed = {"x": _R.randn(3, 6).astype("float32")}
    progs, runs = _both(build, steps=1, feed=feed)
    _same_ops(progs["ref"][0], progs["port"][0])
    for a, b in zip(runs["ref"][0], runs["port"][0]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    for name in ("tanh", "sigmoid", "log", "square", "sqrt", "sign"):
        assert getattr(port_ops, name) is getattr(ptt.layers.nn, name)


# ---------------------------------------------------------------------------
# 3. the initializers
# ---------------------------------------------------------------------------
def _init_program(pkg, init, shape):
    return pkg.layers.create_parameter(
        shape, "float32", attr=pkg.ParamAttr(name="w", initializer=init(pkg)))


INITS = {
    "truncated_normal": (lambda pkg: pkg.initializer.TruncatedNormal(
        0.5, 2.0, seed=3), [200, 150]),
    "msra_uniform": (lambda pkg: pkg.initializer.MSRA(seed=5), [6, 4, 3, 3]),
    "msra_normal": (lambda pkg: pkg.initializer.MSRAInitializer(
        uniform=False, fan_in=20, seed=5), [30, 7]),
    "bilinear": (lambda pkg: pkg.initializer.Bilinear(), [3, 2, 4, 5]),
    "bilinear_odd": (lambda pkg: pkg.initializer.BilinearInitializer(),
                     [2, 1, 3, 3]),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_matches_reference(name):
    """The startup program's init op and its attrs, op for op; Bilinear's
    values exact; the random draws' range (and for TruncatedNormal the
    truncated distribution's mean and std) in both packages."""
    init, shape = INITS[name]
    vals, progs = {}, {}
    for key, pkg, place in (("ref", fluid, fluid.CPUPlace()),
                            ("port", ptt, ptt.CPUPlace())):
        main, startup, _ = _build(pkg, lambda p: _init_program(p, init, shape))
        progs[key] = startup
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            pkg.Executor(place).run(startup)
            vals[key] = np.asarray(scope.find_var("w"))
    _same_ops(progs["ref"], progs["port"])
    got, want = vals["port"], vals["ref"]
    assert got.shape == want.shape == tuple(shape) and got.dtype == np.float32
    if name.startswith("bilinear"):
        np.testing.assert_array_equal(got, want)
        return
    if name == "truncated_normal":
        _truncated_normal_stats(got, 0.5, 2.0)
        _truncated_normal_stats(want, 0.5, 2.0)
        assert not np.array_equal(got, want)  # two streams
        return
    op = json.loads(progs["port"].to_json())["blocks"][0]["ops"][0]
    if name == "msra_uniform":
        limit = math.sqrt(6.0 / (4 * 3 * 3))
        assert op["type"] == "uniform_random"
        assert op["attrs"]["min"] == pytest.approx(-limit)
        assert np.abs(got).max() <= limit
    else:
        assert op["type"] == "gaussian_random"
        assert op["attrs"]["std"] == pytest.approx(math.sqrt(2.0 / 20))


def _truncated_normal_stats(v, mean, std):
    """Samples within mean +- 2 std, their mean and std those of the
    normal truncated at 2 std (0 and 0.8796 std) within 5 standard
    errors."""
    n = v.size
    assert v.min() >= mean - 2 * std and v.max() <= mean + 2 * std
    phi2 = math.exp(-2.0) / math.sqrt(2 * math.pi)  # the density at 2
    mass = math.erf(2 / math.sqrt(2))
    t_std = std * math.sqrt(1 - 4 * phi2 / mass)
    assert abs(v.mean() - mean) <= 5 * t_std / math.sqrt(n)
    assert abs(v.std() - t_std) <= 5 * t_std / math.sqrt(2 * n)


def test_truncated_gaussian_random_lowering():
    """The op alone: the dtype, shape, mean and std attrs, and the
    draw's seed (the same seed, the same samples; another, others)."""
    attrs = {"shape": [300, 200], "dtype": "float32", "mean": -1.0,
             "std": 0.5, "seed": 9}
    lower = get_op("truncated_gaussian_random").lower
    a = lower(LowerCtx(device="cpu"), {}, attrs)["Out"][0]
    b = lower(LowerCtx(device="cpu"), {}, attrs)["Out"][0]
    c = lower(LowerCtx(device="cpu"), {}, dict(attrs, seed=10))["Out"][0]
    assert a.dtype == torch.float32 and tuple(a.shape) == (300, 200)
    assert torch.equal(a, b) and not torch.equal(a, c)
    _truncated_normal_stats(a.numpy(), -1.0, 0.5)
    ref = ref_op("truncated_gaussian_random").lower(RefCtx(), {}, attrs)
    _truncated_normal_stats(np.asarray(ref["Out"][0]), -1.0, 0.5)


# ---------------------------------------------------------------------------
# 4. the API surface
# ---------------------------------------------------------------------------
def _params(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("path", [
    "WeightNormParamAttr", "name_scope", "cpu_places", "as_numpy",
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "initializer.init_on_cpu",
    "initializer.force_init_on_cpu", "initializer.TruncatedNormal",
    "initializer.MSRA", "initializer.Bilinear",
    "layers.exponential_decay", "layers.natural_exp_decay",
    "layers.inverse_time_decay", "layers.polynomial_decay",
    "layers.piecewise_decay", "layers.cosine_decay",
    "layers.linear_lr_warmup", "layers.append_LARS", "layers.exp",
    "layers.floor", "layers.selu", "layers.gelu"])
def test_names_have_the_reference_signatures(path):
    def find(pkg):
        obj = pkg
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    ref, port = find(fluid), find(ptt)
    if inspect.isclass(ref):
        assert _params(port.__init__) == _params(ref.__init__)
    else:
        assert _params(port) == _params(ref)


def test_top_level_classes_and_helpers():
    """Block, Operator, Variable and Parameter are the framework's; the
    LayerHelper members behave as the reference's; WeightNormParamAttr
    carries dim and nothing reads it; name_scope nests; cpu_places gives
    CPUPlaces."""
    assert (ptt.Block, ptt.Operator, ptt.Variable, ptt.Parameter) == (
        framework.Block, framework.Operator, framework.Variable,
        framework.Parameter)
    attr = ptt.WeightNormParamAttr(dim=1, name="v", learning_rate=0.5)
    assert isinstance(attr, ptt.ParamAttr) and attr.dim == 1
    assert attr._to_kwargs() == ptt.ParamAttr(name="v",
                                              learning_rate=0.5)._to_kwargs()
    with ptt.name_scope("outer"):
        with ptt.name_scope():
            assert framework._name_scope_stack == ["outer", ""]
    assert framework._name_scope_stack == []
    assert ptt.cpu_places() == [ptt.CPUPlace()]
    assert ptt.cpu_places(3) == [ptt.CPUPlace()] * 3
    x = ptt.layers.data("x", shape=[4])
    helper = LayerHelper("probe", input=x, act="relu")
    assert helper.input() is x
    assert LayerHelper.create_tmp_variable is \
        LayerHelper.create_variable_for_type_inference
    tmp = helper.create_tmp_variable("float32")
    assert tmp.name.startswith("probe") and not tmp.persistable
    var = helper.create_variable(name="made", shape=[2], dtype="float32")
    assert framework.default_main_program().global_block().var("made") is var
    helper.is_instance("input", framework.Variable)
    with pytest.raises(TypeError, match="act must be"):
        helper.is_instance("act", framework.Variable)
    with pytest.raises(ValueError, match="exactly one input"):
        LayerHelper("probe", input=[x, x]).input()
    ref_helper = fluid.layer_helper.LayerHelper
    for name in ("input", "create_variable", "create_tmp_variable",
                 "is_instance"):
        assert _params(getattr(LayerHelper, name)) == _params(
            getattr(ref_helper, name))


def test_places_report_the_torch_build():
    """is_compiled_with_cuda says whether torch was built with CUDA, as
    the reference's is_compiled_with_tpu reports its accelerator; the
    TPU places are not ported (a documented deviation)."""
    assert ptt.is_compiled_with_cuda() is torch.backends.cuda.is_built()
    assert ptt.is_compiled_with_cuda() is (torch.version.cuda is not None)
    assert ptt.places.is_compiled_with_cuda is ptt.is_compiled_with_cuda
    for name in ("TPUPlace", "TPUPinnedPlace", "tpu_places",
                 "is_compiled_with_tpu"):
        assert hasattr(fluid, name) and not hasattr(ptt, name), name
