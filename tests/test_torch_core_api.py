"""The runtime core of paddle_tpu_torch against the reference: SelectedRows
(``core/selected_rows.py``: merged / densify with duplicates and
padding), the sparse ``lookup_table_grad``, the SelectedRows branches of
``scale`` and ``sum`` and the runner's densifying of SelectedRows
inputs and fetches, the ``log_loss``, ``pow``, ``auc`` and clip ops
(``clip_by_norm``, ``elementwise_max``, ``sqrt``, ``square``, ``sign``)
with their grads, ``calc_gradient`` and ``append_backward(callbacks=)``,
the ``Program`` / ``Block`` / ``Operator`` / ``Scope`` members, the
flags (names, defaults, the environment's two forms) and ``assign`` from
a host value.  Op outputs: rtol = atol = 1e-5 in float32; indices and
counts exactly."""

import importlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import flags as ref_flags
from paddle_tpu.core import scope as ref_scope
from paddle_tpu.core.registry import LowerCtx as RefCtx
from paddle_tpu.core.registry import get_op as ref_op
from paddle_tpu.core.selected_rows import SelectedRows as RefRows
from paddle_tpu.core.selected_rows import densify_maybe as ref_densify
import paddle_tpu_torch as ptt
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch.core import scope as port_scope
from paddle_tpu_torch.core.registry import LowerCtx, get_op
from paddle_tpu_torch.core.selected_rows import SelectedRows, densify_maybe

from test_torch_ctr import (  # noqa: F401  (fresh_port_state: a fixture)
    assert_same_programs,
    fresh_port_state,
    run_port,
    run_reference,
)
from test_torch_ops import _check, _grad_attrs, _run_both

TOL = dict(rtol=1e-5, atol=1e-5)
_R = np.random.RandomState(31)


def _f(*shape):
    return _R.randn(*shape).astype("float32")


def _rows(height=10, n=16, width=4):
    """Rows with duplicates and padding slots (row == height) between
    real ones, as a sum of merged values can hold them."""
    rows = _R.randint(0, height, n).astype("int64")
    rows[1] = rows[6] = rows[13] = rows[3]
    rows[5] = rows[9] = height
    return rows, _f(n, width), height


def _both_rows(rows, vals, height):
    return (RefRows(jnp.asarray(rows.astype("int32")), jnp.asarray(vals),
                    height),
            SelectedRows(torch.tensor(rows), torch.tensor(vals), height))


# ---------------------------------------------------------------------------
# SelectedRows
# ---------------------------------------------------------------------------
def test_selected_rows_merged_and_densify_match_reference():
    """merged(): the compacted rows exactly and the summed values, the
    input's padding slots merged into one slot of row height and the
    rest padding (row height, value 0); densify() of the raw and the
    merged value as the reference's scatter-add (its mode="drop"
    dropping the padding)."""
    ref, port = _both_rows(*_rows())
    rm, pm = ref.merged(), port.merged()
    np.testing.assert_array_equal(pm.rows.numpy(), np.asarray(rm.rows))
    np.testing.assert_allclose(pm.value.numpy(), np.asarray(rm.value), **TOL)
    assert pm.rows.dtype == torch.int64 and pm.height == rm.height
    n_real = len(set(port.rows.tolist()) - {port.height})
    assert (pm.rows[n_real:] == port.height).all()
    assert (pm.value[n_real + 1:] == 0).all()
    for r, p in ((ref, port), (rm, pm), (rm, pm.merged())):
        np.testing.assert_allclose(p.densify().numpy(),
                                   np.asarray(r.densify()), **TOL)
    assert port.dense_shape == ref.dense_shape == (10, 4)
    assert port.dtype == torch.float32
    half = port.astype(torch.float64).scaled(0.5)
    np.testing.assert_allclose(half.densify().numpy(),
                               0.5 * np.asarray(ref.densify()), **TOL)
    assert densify_maybe(port).shape == (10, 4)
    x = torch.ones(2)
    assert densify_maybe(x) is x


def test_selected_rows_merge_has_static_shapes():
    """Every shape of merged() is the lookup count, whatever the ids:
    no torch.unique, nonzero or boolean-mask indexing, so a step that
    carries one can be captured."""
    for ids in ([3, 3, 3, 3], [0, 1, 2, 3], [5, 0, 5, 9]):
        sr = SelectedRows(torch.tensor(ids), torch.ones(4, 2), 10)
        m = sr.merged()
        assert m.rows.shape == (4,) and m.value.shape == (4, 2)


@pytest.mark.parametrize("padding_idx", [-1, 4])
def test_sparse_lookup_table_grad_matches_reference(padding_idx):
    """lookup_table_grad with is_sparse: a SelectedRows of the ids and
    Out@GRAD's rows (padding_idx rows zeroed), never [vocab, dim]; its
    dense form equals the dense-mode gradient (the vjp)."""
    from paddle_tpu.core.registry import lower_grad_op as ref_grad

    w, ids = _f(9, 5), _R.randint(0, 9, (6, 4, 1)).astype("int64")
    ids[0, 0, 0] = ids[2, 1, 0] = 4
    dout = _f(6, 4, 5)
    ins = {"W": [w], "Ids": [ids], "Out@GRAD": [dout]}
    out = {}
    for sparse in (True, False):
        fwd = {"padding_idx": padding_idx, "is_sparse": sparse,
               "is_distributed": False}
        attrs = _grad_attrs("lookup_table", fwd, {"W": 0, "Ids": 0}, ["Out"])
        ref = ref_op("lookup_table_grad").lower(
            RefCtx(), {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
            attrs)
        port = get_op("lookup_table_grad").lower(
            LowerCtx(device="cpu"),
            {s: [torch.tensor(a) for a in v] for s, v in ins.items()}, attrs)
        r, p = ref["W@GRAD"][0], port["W@GRAD"][0]
        if sparse:
            assert isinstance(p, SelectedRows) and p.height == 9
            np.testing.assert_array_equal(p.rows.numpy(), np.asarray(r.rows))
            np.testing.assert_allclose(p.value.numpy(), np.asarray(r.value),
                                       **TOL)
            if padding_idx == 4:
                assert (p.value[p.rows == 4] == 0).all()
            p = p.densify()
        else:
            assert ref_grad is not None and torch.is_tensor(p)
        out[sparse] = p.numpy()
    np.testing.assert_allclose(out[True], out[False], **TOL)
    assert "lookup_table_v2_grad" in ptt.core.registry.OPS
    _check("lookup_table_v2", {"W": [w], "Ids": [ids]},
           {"padding_idx": padding_idx}, exact=True)


@pytest.mark.parametrize("bias", [0.0, 0.5])
def test_scale_and_sum_selected_rows_branches_match_reference(bias):
    """scale of a SelectedRows stays sparse without a bias and densifies
    with one; sum over SelectedRows alone concatenates them, a mix with a
    dense input densifies (regularization on a sparse gradient)."""
    (r1, p1), (r2, p2) = _both_rows(*_rows()), _both_rows(*_rows())
    dense = _f(10, 4)
    attrs = {"scale": 0.3, "bias": bias, "bias_after_scale": True}
    r_out = ref_op("scale").lower(RefCtx(), {"X": [r1]}, attrs)["Out"][0]
    p_out = get_op("scale").lower(LowerCtx(device="cpu"), {"X": [p1]},
                                  attrs)["Out"][0]
    assert isinstance(p_out, SelectedRows) == (bias == 0.0)
    np.testing.assert_allclose(densify_maybe(p_out).numpy(),
                               np.asarray(ref_densify(r_out)), **TOL)
    for xs_r, xs_p in (([r1, r2], [p1, p2]),
                       ([r1, jnp.asarray(dense)], [p1, torch.tensor(dense)])):
        r_sum = ref_op("sum").lower(RefCtx(), {"X": xs_r}, {})["Out"][0]
        p_sum = get_op("sum").lower(LowerCtx(device="cpu"), {"X": xs_p},
                                    {})["Out"][0]
        assert isinstance(p_sum, SelectedRows) == isinstance(r_sum, RefRows)
        if isinstance(p_sum, SelectedRows):
            assert p_sum.rows.shape == (32,)
            np.testing.assert_array_equal(p_sum.rows.numpy(),
                                          np.asarray(r_sum.rows))
        np.testing.assert_allclose(densify_maybe(p_sum).numpy(),
                                   np.asarray(ref_densify(r_sum)), **TOL)


def test_runner_densifies_selected_rows_for_other_ops_and_fetches():
    """A sparse table's W@GRAD fetched is the dense [vocab, dim] gradient
    (the same as the dense-mode program's), and an op without
    handles_selected_rows (here the mean a user appends on it) reads it
    dense; the optimizer ops read the SelectedRows."""
    vals = {}
    for sparse in (True, False):
        main, start = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, start), ptt.unique_name.guard():
            ids = ptt.layers.data("ids", shape=[1], dtype="int64")
            emb = ptt.layers.embedding(ids, size=[7, 3], is_sparse=sparse)
            loss = ptt.layers.mean(ptt.layers.square(emb))
            _, params_grads = ptt.optimizer.SGD(0.1).minimize(loss)
            (_, grad), = params_grads
            g_mean = ptt.layers.mean(grad)
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            exe = ptt.Executor(ptt.CPUPlace())
            exe.run(start)
            feed = {"ids": np.array([[1], [5], [1], [0]], "int64")}
            vals[sparse] = exe.run(main, feed=feed, fetch_list=[grad, g_mean])
    assert vals[True][0].shape == (7, 3)
    for a, b in zip(vals[True], vals[False]):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# loss, metric and clip ops
# ---------------------------------------------------------------------------
_P = np.clip(_R.rand(12, 1).astype("float32"), 0.02, 0.98)
_Y = _R.randint(0, 2, (12, 1)).astype("float32")
_OPS = {
    "log_loss": ("log_loss", {"Predicted": [_P], "Labels": [_Y]},
                 {"epsilon": 1e-4}),
    "log_loss_eps": ("log_loss", {"Predicted": [_P], "Labels": [_Y]},
                     {"epsilon": 1e-6}),
    "pow": ("pow", {"X": [_f(3, 5)]}, {"factor": 2.0}),
    "pow_frac": ("pow", {"X": [np.abs(_f(3, 5)) + 0.1]}, {"factor": 1.5}),
    "clip_by_norm": ("clip_by_norm", {"X": [_f(4, 3)]}, {"max_norm": 0.5}),
    "clip_by_norm_under": ("clip_by_norm", {"X": [0.01 * _f(4, 3)]},
                           {"max_norm": 5.0}),
    "elementwise_max": ("elementwise_max", {"X": [_f(4, 3)],
                                            "Y": [_f(4, 3)]}, {"axis": -1}),
    "elementwise_max_bcast": ("elementwise_max", {"X": [_f(4, 3)],
                                                  "Y": [_f(1)]},
                              {"axis": -1}),
    "sqrt": ("sqrt", {"X": [np.abs(_f(4, 3)) + 0.1]}, {}),
    "square": ("square", {"X": [_f(4, 3)]}, {}),
    "sign": ("sign", {"X": [np.array([-2.0, 0.0, 3.0, -0.0], "float32")]},
             {}),
}


@pytest.mark.parametrize("case", sorted(_OPS))
def test_loss_and_clip_ops_match_reference(case):
    _check(*_OPS[case])


@pytest.mark.parametrize("case", sorted(set(_OPS) - {"sign"}))
def test_loss_and_clip_op_grads_match_reference(case):
    """<op>_grad through torch.func.vjp against the reference's jax.vjp,
    with the same cotangent."""
    from paddle_tpu.core.registry import lower_grad_op as ref_grad
    from paddle_tpu_torch.core.registry import lower_grad_op

    op_type, ins, attrs = _OPS[case]
    fwd, _ = _run_both(op_type, ins, attrs)
    out_slots = list(fwd)
    gins = dict(ins, **{s + "@GRAD": [_f(*a.shape) for a in fwd[s]]
                        for s in out_slots})
    gattrs = _grad_attrs(op_type, attrs, ins, out_slots)
    ref = ref_grad(RefCtx(), None,
                   {s: [jnp.asarray(a) for a in v] for s, v in gins.items()},
                   gattrs)
    out = lower_grad_op(LowerCtx(device="cpu"),
                        {s: [torch.tensor(a) for a in v]
                         for s, v in gins.items()}, gattrs)
    assert set(out) == set(ref)
    for slot in ref:
        for a, b in zip(ref[slot], out[slot]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("curve,slide", [("ROC", 0), ("ROC", 3), ("PR", 0),
                                          ("PR", 2)])
def test_auc_matches_reference(curve, slide):
    """auc over [N] scores and [N, 2] probabilities, with scores on the
    bucket edges 0 and 1: the AUC and both histograms (integer counts,
    exactly)."""
    n, nt = 40, 63
    nb, rows = nt + 1, max(1, slide)
    score = _R.rand(n).astype("float32")
    score[:3] = [0.0, 1.0, 0.5]
    label = _R.randint(0, 2, (n, 1)).astype("int64")
    stat_pos = _R.randint(0, 5, (rows, nb)).astype("float32")
    stat_neg = _R.randint(0, 5, (rows, nb)).astype("float32")
    attrs = {"num_thresholds": nt, "curve": curve, "slide_steps": slide}
    for predict in (score, np.stack([1 - score, score], 1)):
        ins = {"Predict": [predict], "Label": [label],
               "StatPos": [stat_pos], "StatNeg": [stat_neg]}
        ref, out = _run_both("auc", ins, attrs)
        np.testing.assert_allclose(out["AUC"][0], ref["AUC"][0], **TOL)
        for slot in ("StatPosOut", "StatNegOut"):
            np.testing.assert_array_equal(out[slot][0], ref[slot][0])
    with pytest.raises(ValueError):
        get_op("auc").lower(LowerCtx(device="cpu"), {
            "Predict": [torch.tensor(score)], "Label": [torch.tensor(label)],
            "StatPos": [torch.tensor(stat_pos)],
            "StatNeg": [torch.tensor(stat_neg)]}, dict(attrs, curve="XY"))


# ---------------------------------------------------------------------------
# backward: calc_gradient and callbacks
# ---------------------------------------------------------------------------
def _mlp(pkg, use_calc):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[4])
        h = pkg.layers.fc(x, size=3, act="relu")
        loss = pkg.layers.mean(pkg.layers.pow(h, 2.0))
        backward = importlib.import_module(pkg.__name__ + ".backward")
        if use_calc:
            grads = backward.calc_gradient(loss, [h, x])
        else:
            calls = []
            grads = backward.append_backward(
                loss, callbacks=[lambda *a, **k: calls.append(a)])
            assert calls == []  # accepted, never called, as the reference
    return main, start, loss, grads


@pytest.mark.parametrize("use_calc", [True, False])
def test_calc_gradient_and_append_backward_callbacks(use_calc):
    """calc_gradient of a loss with respect to a hidden var and a data
    var (None where no gradient reaches: x stops gradients), and
    append_backward(callbacks=): the same programs as the reference's,
    the gradients' values as its."""
    r_main, r_start, r_loss, r_grads = _mlp(fluid, use_calc)
    p_main, p_start, p_loss, p_grads = _mlp(ptt, use_calc)
    assert_same_programs([r_start, r_main], [p_start, p_main])
    if use_calc:
        assert p_grads[1] is None and r_grads[1] is None
        p_fetch, r_fetch = [p_grads[0]], [r_grads[0]]
    else:
        assert [(p.name, g.name) for p, g in p_grads] == [
            (p.name, g.name) for p, g in r_grads]
        p_fetch = [g for _, g in p_grads]
        r_fetch = [g for _, g in r_grads]
    feeds = [{"x": _f(5, 4)}]
    init, r_runs, _, _ = run_reference(r_main, r_start, r_fetch, feeds)
    runs, _, _ = run_port(p_main, init, p_fetch, feeds)
    for a, b in zip(runs[0], r_runs[0]):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# Program, Block, Operator, Scope
# ---------------------------------------------------------------------------
def _edit(pkg):
    prog = pkg.Program()
    blk = prog.global_block()
    for n in ("a", "b", "c"):
        blk.create_var(name=n, shape=[2], dtype="float32")
    blk.append_op("scale", inputs={"X": ["a"]}, outputs={"Out": ["b"]},
                  attrs={"scale": 2.0})
    blk.prepend_op("fill_constant", outputs={"Out": ["a"]},
                   attrs={"shape": [2], "dtype": "float32", "value": 1.5})
    blk.insert_op(2, "scale", inputs={"X": ["b"]}, outputs={"Out": ["c"]},
                  attrs={"scale": 3.0})
    blk.insert_op(1, "sign", inputs={"X": ["a"]}, outputs={"Out": ["b"]})
    blk.remove_op(1)
    v0 = prog._version
    sub = prog.create_block()
    sub.create_var(name="d", shape=[2], dtype="float32")
    made = (prog.current_block_idx, sub.parent_idx, prog._version > v0)
    prog.rollback()
    return prog, made


def test_program_block_operator_members_match_reference():
    """create_block / rollback, prepend_op / insert_op / remove_op, and
    Operator.input / output / has_attr / attr: the same program as the
    reference's edits make, and it runs (c = 3 * 2 * 1.5)."""
    r_prog, r_made = _edit(fluid)
    p_prog, p_made = _edit(ptt)
    assert p_made == r_made == (1, 0, True)
    assert p_prog.current_block_idx == r_prog.current_block_idx == 0
    assert p_prog.num_blocks == r_prog.num_blocks == 2
    rd, pd = json.loads(r_prog.to_json()), json.loads(p_prog.to_json())
    assert pd == rd
    op = p_prog.global_block().ops[1]
    assert (op.type, op.input("X"), op.output("Out")) == ("scale", ["a"],
                                                          ["b"])
    assert op.input("Missing") == [] and op.output("Missing") == []
    assert op.has_attr("scale") and not op.has_attr("bias")
    assert op.attr("scale") == 2.0
    with pytest.raises(KeyError):
        op.attr("bias")
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        out = ptt.Executor(ptt.CPUPlace()).run(p_prog, fetch_list=["c"])
    np.testing.assert_array_equal(out[0], np.full(2, 9.0, "float32"))


def _scope_walk(mod, value):
    root = mod.Scope()
    kid = root.new_scope()
    grand = kid.new_scope()
    root.set("w", value(1.0))
    assert root.var("w") == "w" and root.var("fresh") == "fresh"
    kid.set("k", value(2.0))
    grand.set("w", value(3.0))  # written where it exists: root
    grand.var("g")
    names = grand.all_var_names()
    seen = (grand.has_var("fresh"), grand.has_var("g"), grand.has_var("w"),
            float(np.asarray(grand.get("w"))[0]), root.get("nothing"))
    kid.erase("k")
    kid.erase("never")
    gone = kid.find_var("k")
    kids_before = len(root._kids)
    root.drop_kids()
    return names, seen, gone, kids_before, len(root._kids)


def test_scope_members_match_reference():
    """var (get-or-create, None until set), get, erase, new_scope,
    drop_kids, all_var_names, walked the same way in both packages."""
    r = _scope_walk(ref_scope, lambda v: np.full(2, v, "float32"))
    p = _scope_walk(port_scope, lambda v: torch.full((2,), v))
    assert p == r
    assert p[0] == ["g", "k", "w", "fresh"]
    assert p[1] == (False, False, True, 3.0, None)


# ---------------------------------------------------------------------------
# flags, assign from a host value
# ---------------------------------------------------------------------------
def test_flags_have_the_reference_names_and_defaults():
    """Every flag of the reference, in its order, with its default and
    type; set_flags coerces and refuses an unknown name; the liveness
    pair is clamped as the reference clamps it; each help says what
    reads it in the port (nothing yet: where it goes)."""
    assert list(port_flags._flags) == list(ref_flags._flags)
    for name, f in ref_flags._flags.items():
        pf = port_flags._flags[name]
        assert pf.default == f.default and type(pf.default) is type(
            f.default), name
        assert "port" in pf.help or "ROADMAP" in pf.help, name
    saved = port_flags.flag_items()
    try:
        port_flags.set_flags({"FLAGS_benchmark": "1", "rpc_deadline": "7",
                              "fraction_of_gpu_memory_to_use": "0.5"})
        assert port_flags.get_flag("benchmark") is True
        assert port_flags.get_flag("rpc_deadline") == 7
        assert port_flags.get_flag("fraction_of_gpu_memory_to_use") == 0.5
        with pytest.raises(KeyError):
            port_flags.set_flags({"no_such_flag": 1})
        port_flags.set_flags({"heartbeat_interval": 5.0,
                              "eviction_deadline": 4.0})
        assert port_flags.get_flag("eviction_deadline") == 15.0
    finally:
        for name, v in saved.items():
            port_flags._flags[name].value = v


def test_flags_load_from_the_environment(monkeypatch):
    """FLAGS_<name> and the PADDLE_TPU_FLAGS batch form, read at import,
    as the reference reads them."""
    monkeypatch.setenv("FLAGS_check_nan_inf", "true")
    monkeypatch.setenv("FLAGS_max_retry", "3")
    monkeypatch.setenv("PADDLE_TPU_FLAGS",
                       "--feed_prefetch=5 --prng_impl=rbg --unknown=1")
    try:
        for mod in (port_flags, ref_flags):
            importlib.reload(mod)
        assert port_flags.flag_items() == ref_flags.flag_items()
        items = port_flags.flag_items()
        assert items["check_nan_inf"] is True and items["max_retry"] == 3
        assert items["feed_prefetch"] == 5 and items["prng_impl"] == "rbg"
    finally:
        monkeypatch.undo()
        for mod in (port_flags, ref_flags):
            importlib.reload(mod)
    assert port_flags.get_flag("max_retry") == 30


@pytest.mark.parametrize("value", [
    np.arange(6, dtype="float32").reshape(2, 3) * 0.5,
    np.array([3, -1, 7], "int64"), [[1.0, 2.0]]])
def test_assign_from_a_host_value_matches_reference(value):
    """assign(numpy) appends assign_value with the array's shape, values
    and dtype, as the reference's; running it gives the reference's
    array (float64 runs as float32 in both; int64 as int32 in the
    reference, whose dtype policy it is, and as int64 in the port)."""
    def build(pkg):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            out = pkg.layers.assign(value)
        return main, start, out

    r_main, r_start, r_out = build(fluid)
    p_main, p_start, p_out = build(ptt)
    assert_same_programs([r_start, r_main], [p_start, p_main])
    assert p_main.global_block().ops[0].type == "assign_value"
    init, r_runs, _, _ = run_reference(r_main, r_start, [r_out], [{}])
    runs, _, _ = run_port(p_main, init, [p_out], [{}])
    want = r_runs[0][0]
    assert runs[0][0].dtype == {"int32": np.int64}.get(want.dtype.name,
                                                       want.dtype)
    np.testing.assert_array_equal(runs[0][0], want)
    np.testing.assert_array_equal(want, np.asarray(value).astype(want.dtype))
