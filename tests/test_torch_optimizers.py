"""paddle_tpu_torch's optimizers against the reference
(``paddle_tpu/ops/optimizer_ops.py``, ``optimizer.py``, ``clip.py``,
``regularizer.py``):

- every optimizer op lowering on shared numpy inputs, dense, and the
  SelectedRows branches of sgd, momentum (Nesterov too), lazy adam and
  adagrad with duplicate rows and padding slots (row == height);
- each optimizer class, with and without is_sparse where the reference
  has a sparse branch, and gradient clipping (by value, norm and global
  norm) and regularization (L1, L2; the optimizer's and a ParamAttr's):
  the programs op for op with the same JSON, and 5 steps of the narrow
  DeepFM from the reference's startup arrays;
- ModelAverage's apply / restore and GradientMergeOptimizer with k 2.

Tolerance: rtol = atol = 1e-5 on the op outputs; losses rtol 1e-5;
every parameter and accumulator within 1e-5 of its largest magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import regularizer as ref_reg
from paddle_tpu.core.registry import LowerCtx as RefCtx
from paddle_tpu.core.registry import get_op as ref_op
from paddle_tpu.core.selected_rows import SelectedRows as RefRows
from paddle_tpu.models import ctr_deepfm as ref_deepfm
import paddle_tpu_torch as ptt
from paddle_tpu_torch import regularizer as port_reg
from paddle_tpu_torch.core.registry import LowerCtx, get_op
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.models import ctr_deepfm as port_deepfm

from test_torch_ctr import (  # noqa: F401  (fresh_port_state: a fixture)
    assert_same_programs,
    assert_state_close,
    build_deepfm,
    fresh_port_state,
    narrow_feed,
    run_port,
    run_reference,
)

TOL = dict(rtol=1e-5, atol=1e-5)
_R = np.random.RandomState(23)


def _f(*shape, positive=False):
    a = _R.randn(*shape).astype("float32")
    return np.abs(a) + 0.1 if positive else a


def _rows_case(height=9, n=12, width=3):
    """Rows with duplicates and two padding slots (row == height)."""
    rows = _R.randint(0, height, n).astype("int64")
    rows[2] = rows[5] = rows[9]
    rows[4] = rows[11] = height
    return rows, _f(n, width), height


def _lower_both(op_type, ins, attrs, rows=None):
    """The op through both lowerings on copies of the same inputs; with
    `rows` (rows, values, height) the Grad slot is a SelectedRows."""
    r_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    p_ins = {s: [torch.tensor(a) for a in v] for s, v in ins.items()}
    if rows is not None:
        r, v, h = rows
        r_ins["Grad"] = [RefRows(jnp.asarray(r.astype("int32")),
                                 jnp.asarray(v), h)]
        p_ins["Grad"] = [SelectedRows(torch.tensor(r), torch.tensor(v), h)]
    ref = ref_op(op_type).lower(RefCtx(), r_ins, attrs)
    out = get_op(op_type).lower(LowerCtx(device="cpu"), p_ins, attrs)
    assert set(out) == set(ref), (op_type, set(out), set(ref))
    for slot in ref:
        for a, b in zip(ref[slot], out[slot]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                       err_msg=slot)
    return out


def _optimizer_ins(op_type, shape):
    lr = np.array([0.05], "float32")
    p, g = _f(*shape), _f(*shape)
    acc = lambda: _f(*shape, positive=True)  # noqa: E731
    pow_ = lambda v: np.array([v], "float32")  # noqa: E731
    return {
        "sgd": {"Param": [p], "Grad": [g], "LearningRate": [lr]},
        "momentum": {"Param": [p], "Grad": [g], "Velocity": [_f(*shape)],
                     "LearningRate": [lr]},
        "lars_momentum": {"Param": [p], "Grad": [g],
                          "Velocity": [_f(*shape)], "LearningRate": [lr]},
        "adam": {"Param": [p], "Grad": [g], "Moment1": [_f(*shape)],
                 "Moment2": [acc()], "Beta1Pow": [pow_(0.9 ** 3)],
                 "Beta2Pow": [pow_(0.999 ** 3)], "LearningRate": [lr]},
        "adamax": {"Param": [p], "Grad": [g], "Moment": [_f(*shape)],
                   "InfNorm": [acc()], "Beta1Pow": [pow_(0.9 ** 2)],
                   "LearningRate": [lr]},
        "adagrad": {"Param": [p], "Grad": [g], "Moment": [acc()],
                    "LearningRate": [lr]},
        "proximal_gd": {"Param": [p], "Grad": [g], "LearningRate": [lr]},
        "proximal_adagrad": {"Param": [p], "Grad": [g], "Moment": [acc()],
                             "LearningRate": [lr]},
        "decayed_adagrad": {"Param": [p], "Grad": [g], "Moment": [acc()],
                            "LearningRate": [lr]},
        "adadelta": {"Param": [p], "Grad": [g], "AvgSquaredGrad": [acc()],
                     "AvgSquaredUpdate": [acc()]},
        "rmsprop": {"Param": [p], "Grad": [g], "Moment": [_f(*shape)],
                    "MeanSquare": [acc() + 1.0], "MeanGrad": [_f(*shape)],
                    "LearningRate": [lr]},
        "ftrl": {"Param": [p], "Grad": [g], "SquaredAccumulator": [acc()],
                 "LinearAccumulator": [_f(*shape)], "LearningRate": [lr]},
        "model_average_accum": {"Param": [p], "Sum": [_f(*shape)],
                                "Num": [pow_(3.0)],
                                "NumUpdates": [pow_(7.0)]},
    }[op_type]


_DENSE = {
    "sgd": ("sgd", {}),
    "momentum": ("momentum", {"mu": 0.9}),
    "momentum_nesterov": ("momentum", {"mu": 0.8, "use_nesterov": True}),
    "lars_momentum": ("lars_momentum", {"mu": 0.9, "lars_coeff": 0.001,
                                        "lars_weight_decay": 0.0005}),
    "adam": ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adamax": ("adamax", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ("adagrad", {"epsilon": 1e-6}),
    "proximal_gd": ("proximal_gd", {"l1": 0.01, "l2": 0.1}),
    "proximal_adagrad": ("proximal_adagrad", {"l1": 0.01, "l2": 0.1}),
    "decayed_adagrad": ("decayed_adagrad", {"decay": 0.95,
                                            "epsilon": 1e-6}),
    "adadelta": ("adadelta", {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": ("rmsprop", {"decay": 0.9, "epsilon": 1e-6,
                            "momentum": 0.5, "centered": False}),
    "rmsprop_centered": ("rmsprop", {"decay": 0.9, "epsilon": 1e-6,
                                     "momentum": 0.5, "centered": True}),
    "ftrl": ("ftrl", {"l1": 0.01, "l2": 0.1, "lr_power": -0.5}),
    "ftrl_power": ("ftrl", {"l1": 0.01, "l2": 0.1, "lr_power": -0.7}),
    "model_average_accum": ("model_average_accum",
                            {"average_window_rate": 0.15,
                             "min_average_window": 2,
                             "max_average_window": 4}),
    "model_average_restart": ("model_average_accum",
                              {"average_window_rate": 0.15,
                               "min_average_window": 10000,
                               "max_average_window": 10000}),
}


@pytest.mark.parametrize("case", sorted(_DENSE))
def test_dense_optimizer_op_matches_reference(case):
    op_type, attrs = _DENSE[case]
    _lower_both(op_type, _optimizer_ins(op_type, (6, 3)), attrs)


_SPARSE = {
    "sgd": ("sgd", {}),
    "momentum": ("momentum", {"mu": 0.9}),
    "momentum_nesterov": ("momentum", {"mu": 0.8, "use_nesterov": True}),
    "adam": ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ("adagrad", {"epsilon": 1e-6}),
}


@pytest.mark.parametrize("case", sorted(_SPARSE))
def test_selected_rows_optimizer_op_matches_reference(case):
    """A SelectedRows gradient with duplicate rows and two padding slots
    (row == height), through each sparse branch: the reference drops a
    padding slot in its scatters, the port points it at a real row with a
    zero addend.  Lazy adam and adagrad leave every untouched row of the
    param and moments as it was; momentum decays every row."""
    op_type, attrs = _SPARSE[case]
    rows = _rows_case()
    ins = _optimizer_ins(op_type, (rows[2], 3))
    ins.pop("Grad")
    out = _lower_both(op_type, ins, attrs, rows)
    untouched = sorted(set(range(rows[2])) - set(rows[0].tolist()))
    assert untouched
    for slot, before in (("ParamOut", "Param"), ("Moment1Out", "Moment1"),
                         ("MomentOut", "Moment"), ("VelocityOut",
                                                   "Velocity")):
        if slot not in out:
            continue
        same = np.array_equal(out[slot][0].numpy()[untouched],
                              ins[before][0][untouched])
        assert same == (op_type != "momentum"), (case, slot)


def test_sparse_branches_run_in_place_and_merge_padding():
    """The in-place sparse branches: sgd / adam / adagrad return the
    tensors they were given, so the executor copies nothing back; a
    merged gradient merged again (padding slots in its input) updates
    as the first merge does."""
    rows, vals, h = _rows_case()
    p = torch.tensor(_f(h, 3))
    m = torch.tensor(_f(h, 3, positive=True))
    g = SelectedRows(torch.tensor(rows), torch.tensor(vals), h)
    ins = {"Param": [p.clone()], "Grad": [g], "Moment": [m.clone()],
           "LearningRate": [torch.tensor([0.1])]}
    out = get_op("adagrad").lower(LowerCtx(device="cpu"), ins, {})
    assert out["ParamOut"][0] is ins["Param"][0]
    assert out["MomentOut"][0] is ins["Moment"][0]
    again = dict(ins, Param=[p.clone()], Moment=[m.clone()],
                 Grad=[g.merged()])
    out2 = get_op("adagrad").lower(LowerCtx(device="cpu"), again, {})
    assert torch.equal(out2["ParamOut"][0], out["ParamOut"][0])
    assert torch.equal(out2["MomentOut"][0], out["MomentOut"][0])


# ---------------------------------------------------------------------------
# the optimizer classes on the narrow DeepFM
# ---------------------------------------------------------------------------
def _opt(name, *args, **kw):
    return lambda pkg: getattr(pkg.optimizer, name)(*args, **kw)


def _global_clip(kind, *args):
    def before(pkg):
        import importlib

        clip = importlib.import_module(pkg.__name__ + ".clip")
        clip.set_gradient_clip(getattr(clip, kind)(*args))

    return before


def _reg(pkg):
    return ref_reg if pkg is fluid else port_reg


_CLASSES = {
    "sgd": (_opt("SGD", 0.1), None),
    "momentum": (_opt("Momentum", 0.05, 0.9), None),
    "momentum_nesterov": (_opt("Momentum", 0.05, 0.9, use_nesterov=True),
                          None),
    "adam_lazy": (_opt("Adam", 0.02), None),
    "adagrad": (_opt("Adagrad", 0.05), None),
    "adamax": (_opt("Adamax", 0.02), None),
    "decayed_adagrad": (_opt("DecayedAdagrad", 0.005), None),
    "adadelta": (_opt("Adadelta", 0.5), None),
    "rmsprop": (_opt("RMSProp", 0.01), None),
    "rmsprop_centered": (_opt("RMSProp", 0.01, momentum=0.5, centered=True),
                         None),
    # l2 > 0: a table row no id touched has g = 0 and squared 0, whose
    # FTRL denominator is 2 l2 (0 / 0 without it, in both packages)
    "ftrl": (_opt("Ftrl", 0.05, l1=0.001, l2=0.01), None),
    "lars_momentum": (_opt("LarsMomentum", 0.05), None),
    "global_norm_l2": (lambda pkg: pkg.optimizer.Adagrad(
        0.05, regularization=_reg(pkg).L2Decay(1e-3)),
        _global_clip("GradientClipByGlobalNorm", 0.5)),
    "norm_l1": (lambda pkg: pkg.optimizer.Momentum(
        0.05, 0.9, regularization=_reg(pkg).L1Decay(1e-3)),
        _global_clip("GradientClipByNorm", 0.2)),
    "value": (_opt("SGD", 0.1), _global_clip("GradientClipByValue", 0.01)),
}
_SPARSE_BRANCH = ("sgd", "momentum", "momentum_nesterov", "adam_lazy",
                  "adagrad", "global_norm_l2", "norm_l1")


@pytest.mark.parametrize("case,is_sparse", [
    (c, s) for c in sorted(_CLASSES) for s in (
        (False, True) if c in _SPARSE_BRANCH else (True,))])
def test_optimizer_class_trains_like_reference(case, is_sparse):
    """The class on the narrow DeepFM: the programs op for op with the
    same JSON (clip and regularization ops included), and 5 steps from
    the reference's startup arrays, losses and every parameter and
    accumulator as the reference's.  Optimizers without a sparse branch
    run with is_sparse, so their tables' gradients densify in the
    runner, as in the reference's tracer."""
    make_opt, before = _CLASSES[case]
    r_main, r_start, r_outs, _ = build_deepfm(fluid, ref_deepfm, is_sparse,
                                              make_opt, before=before)
    p_main, p_start, p_outs, _ = build_deepfm(ptt, port_deepfm, is_sparse,
                                              make_opt, before=before)
    assert_same_programs([r_start, r_main], [p_start, p_main])
    types = {o.type for o in p_main.global_block().ops}
    if case == "global_norm_l2":
        assert {"square", "sqrt", "elementwise_max", "scale", "sum"} <= types
    if case == "norm_l1":
        assert {"clip_by_norm", "sign"} <= types
    feeds = [narrow_feed(4 + i % 2) for i in range(5)]
    init, r_runs, final, _ = run_reference(r_main, r_start, [r_outs[1]],
                                           feeds)
    runs, scope, _ = run_port(p_main, init, [p_outs[1]], feeds)
    losses = [float(r[0].sum()) for r in runs]
    np.testing.assert_allclose(losses, [float(r[0].sum()) for r in r_runs],
                               rtol=1e-5)
    assert np.isfinite(losses).all()
    assert assert_state_close(final, scope, init) > len(final) // 2


def test_param_attr_regularizer_and_clip_reach_the_optimizer():
    """ParamAttr(regularizer=, gradient_clip=) on one fc: its weight's
    gradient gets the L1 decay and the value clip, the bias neither;
    the same ops as the reference's and 5 SGD steps as its."""
    def build(pkg):
        import importlib

        clip = importlib.import_module(pkg.__name__ + ".clip")
        pa = importlib.import_module(pkg.__name__ + ".param_attr")
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[5])
            y = pkg.layers.fc(x, size=3, param_attr=pa.ParamAttr(
                name="w", regularizer=_reg(pkg).L1Decay(0.01),
                gradient_clip=clip.GradientClipByValue(0.05)))
            loss = pkg.layers.mean(pkg.layers.square(y))
            pkg.optimizer.SGD(0.5).minimize(loss)
        return main, start, loss

    r_main, r_start, r_loss = build(fluid)
    p_main, p_start, p_loss = build(ptt)
    assert_same_programs([r_start, r_main], [p_start, p_main])
    ops = p_main.global_block().ops
    assert [o.type for o in ops].count("clip") == 1
    assert [o.type for o in ops].count("sign") == 1
    feeds = [{"x": _f(8, 5)} for _ in range(5)]
    init, r_runs, final, _ = run_reference(r_main, r_start, [r_loss], feeds)
    runs, scope, _ = run_port(p_main, init, [p_loss], feeds)
    np.testing.assert_allclose([float(r[0].sum()) for r in runs],
                               [float(r[0].sum()) for r in r_runs],
                               rtol=1e-5)
    assert_state_close(final, scope)


def test_model_average_apply_and_restore_match_reference():
    """Adam, then ModelAverage(0.15, windows 10-20) over 5 steps: the sums
    and counts as the reference's; inside apply() every parameter is its
    windowed average and the test program's loss is the reference's;
    after it the trained values are back."""
    def build(pkg):
        main, start, outs, _ = build_deepfm(pkg, ref_deepfm if pkg is fluid
                                            else port_deepfm, True, None)
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            pkg.optimizer.Adam(0.02).minimize(outs[1])
            test = main.clone(for_test=True)
            avg = pkg.optimizer.ModelAverage(0.15, min_average_window=10,
                                             max_average_window=20)
        return main, start, outs, test, avg

    r_main, r_start, r_outs, r_test, r_avg = build(fluid)
    p_main, p_start, p_outs, p_test, p_avg = build(ptt)
    assert_same_programs([r_start, r_main], [p_start, p_main])
    assert [o.type for o in p_main.global_block().ops].count(
        "model_average_accum") == len(p_main.global_block().all_parameters())
    feeds = [narrow_feed(4 + i % 2) for i in range(5)]

    def averaged(pkg, test, loss, avg):
        def extra(exe, scope):
            trained = {n: np.array(scope.find_var(n)) for n in avg._accums}
            with avg.apply(exe):
                inside = {n: np.array(scope.find_var(n))
                          for n in avg._accums}
                val = float(np.asarray(exe.run(
                    test, feed=feeds[0], fetch_list=[loss])[0]).sum())
            avg.restore(exe)
            for n, v in trained.items():
                np.testing.assert_array_equal(np.array(scope.find_var(n)), v)
            return inside, val

        return extra

    init, _, final, (r_inside, r_val) = run_reference(
        r_main, r_start, [r_outs[1]], feeds,
        averaged(fluid, r_test, r_outs[1], r_avg))
    _, scope, (p_inside, p_val) = run_port(
        p_main, init, [p_outs[1]], feeds,
        averaged(ptt, p_test, p_outs[1], p_avg))
    assert_state_close(final, scope)
    np.testing.assert_allclose(p_val, r_val, rtol=1e-5)
    for n, want in r_inside.items():
        np.testing.assert_allclose(p_inside[n], want, rtol=1e-5, atol=1e-6)
        assert not np.array_equal(want, final[n])  # the average, not p


def test_gradient_merge_k2_matches_reference():
    """GradientMergeOptimizer(Adagrad, k_steps=2): the main program (the
    accumulating adds) and the apply program op for op; 4 micro-steps
    with the apply program after every second, as the reference's."""
    def build(pkg, model):
        main, start, outs, _ = build_deepfm(pkg, model, True, None)
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            opt = pkg.optimizer.GradientMergeOptimizer(
                pkg.optimizer.Adagrad(0.05), k_steps=2)
            apply_prog = opt.minimize(outs[1])
        return main, start, outs, apply_prog

    r_main, r_start, r_outs, r_apply = build(fluid, ref_deepfm)
    p_main, p_start, p_outs, p_apply = build(ptt, port_deepfm)
    assert_same_programs([r_start, r_main, r_apply],
                         [p_start, p_main, p_apply])
    feeds = [narrow_feed(4 + i) for i in range(4)]

    def loop(apply_prog, loss):
        def extra(exe, scope):
            losses = []
            for i, f in enumerate(feeds):
                losses.append(float(np.asarray(exe.run(
                    None, feed=f, fetch_list=[loss])[0]).sum()))
                if i % 2 == 1:
                    exe.run(apply_prog)
            return losses

        return extra

    with fluid.program_guard(r_main, r_start):
        init, _, final, r_losses = run_reference(
            r_main, r_start, [], [], loop(r_apply, r_outs[1]))
    with ptt.program_guard(p_main, p_start):
        _, scope, p_losses = run_port(p_main, init, [], [],
                                      loop(p_apply, p_outs[1]))
    np.testing.assert_allclose(p_losses, r_losses, rtol=1e-5)
    assert assert_state_close(final, scope, init) > len(final) // 2
