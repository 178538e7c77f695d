"""DeepFM CTR training in paddle_tpu_torch against the reference
(``paddle_tpu/models/ctr_deepfm.py``): ``build_deepfm_train`` op for op
(sparse, dense and ``with_auc``), 12 Adam steps on the narrow config of
``tests/test_book.py`` (fields [17, 23, 11], embed_dim 4, batch 32) from
the reference's startup arrays, the streaming AUCs over 5 steps, and the
sparse tables' contract: the embedding gradients reach the optimizer as
SelectedRows (touched rows only), sparse Adagrad equals dense Adagrad,
and run_loop(K) equals K runs.

Tolerance: losses rtol 1e-5; every parameter and accumulator within
1e-5 of its largest magnitude."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.optimizer  # noqa: F401  (fluid.optimizer)
from paddle_tpu import clip as ref_clip
from paddle_tpu.models import ctr_deepfm as ref_deepfm
import paddle_tpu_torch as ptt
import paddle_tpu_torch.optimizer  # noqa: F401  (ptt.optimizer)
from paddle_tpu_torch import clip as port_clip
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import ctr_deepfm as port_deepfm

from test_torch_program import _assert_same_program

FIELDS = [17, 23, 11]
BATCH = 32


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh port programs, scope and name counters per test; no global
    gradient clip left behind in either package."""
    old_main = framework.switch_main_program(framework.Program())
    old_startup = framework.switch_startup_program(framework.Program())
    old_gen = unique_name.switch()
    old_scope = scope_mod._switch_scope(scope_mod.Scope())
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    scope_mod._switch_scope(old_scope)
    ref_clip._clip_attr = port_clip._clip_attr = None


def narrow_feed(seed=4, batch=BATCH, fields=FIELDS, dense_dim=4):
    rng = np.random.RandomState(seed)
    feed = {"C%d" % i: rng.randint(0, d, (batch, 1)).astype("int64")
            for i, d in enumerate(fields)}
    feed["dense"] = rng.rand(batch, dense_dim).astype("float32")
    feed["click"] = rng.randint(0, 2, (batch, 1)).astype("float32")
    return feed


def build_deepfm(pkg, model, is_sparse, make_opt=None, with_auc=False,
                 fields=FIELDS, embed_dim=4, before=None):
    """The builder's program under a fresh name generator; `before(pkg)`
    runs inside the guards first (a global clip), `make_opt(pkg)` gives
    the optimizer to minimize the loss with.  Returns (main, startup,
    outputs, the optimizer's minimize result)."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        if before is not None:
            before(pkg)
        outs = model.build_deepfm_train(fields, dense_dim=4,
                                        embed_dim=embed_dim,
                                        is_sparse=is_sparse,
                                        with_auc=with_auc)
        opt = make_opt(pkg) if make_opt is not None else None
        result = opt.minimize(outs[1]) if opt is not None else None
    return main, start, outs, (opt, result)


def persistables(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _normalized(program):
    data = json.loads(program.to_json())
    for b in data["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":  # the reference's index-var policy
                v["dtype"] = "int64"
    return data


def assert_same_programs(ref_progs, port_progs):
    """Op for op, and the same JSON (``Program.to_json``)."""
    for r, p in zip(ref_progs, port_progs):
        _assert_same_program(r, p)
        assert _normalized(p) == _normalized(r)


def run_reference(main, start, fetch, feeds, extra=None):
    """The reference from its startup program over `feeds` (one run a
    feed); `extra(exe, scope)` runs after.  Returns (startup arrays,
    fetched values a run, final persistables, extra's result)."""
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(start)
        names = persistables(start)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        runs = [[np.asarray(v) for v in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]
        more = extra(exe, scope) if extra is not None else None
        final = {n: np.asarray(scope.find_var(n)) for n in names}
    return init, runs, final, more


def run_port(main, init, fetch, feeds, extra=None):
    """The port from the reference's startup arrays (params_from_numpy)
    over `feeds`.  Returns (fetched values a run, the scope, extra's
    result)."""
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        exe = ptt.Executor(ptt.CPUPlace())
        runs = [[np.asarray(v) for v in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]
        more = extra(exe, scope) if extra is not None else None
    return runs, scope, more


def assert_state_close(final, scope, init=None):
    """Every persistable within 1e-5 of its largest magnitude; with
    `init`, returns how many moved."""
    moved = 0
    for name, want in final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= tol, name
        if init is not None:
            moved += not np.array_equal(want, init[name])
    return moved


@pytest.mark.parametrize("mode", ["dense", "sparse", "auc"])
def test_deepfm_programs_match_reference(mode):
    """build_deepfm_train + Adam: the main and startup programs op for op
    and the same JSON; the lookups carry is_sparse and is_distributed;
    with is_sparse each table's grad op is lookup_table_grad."""
    sparse = mode == "sparse"
    adam = lambda pkg: pkg.optimizer.Adam(0.02)  # noqa: E731
    r_main, r_start, _, _ = build_deepfm(fluid, ref_deepfm, sparse, adam,
                                         with_auc=mode == "auc")
    p_main, p_start, outs, _ = build_deepfm(ptt, port_deepfm, sparse, adam,
                                            with_auc=mode == "auc")
    assert_same_programs([r_start, r_main], [p_start, p_main])
    ops = p_main.global_block().ops
    looks = [o for o in ops if o.type == "lookup_table"]
    assert len(looks) == 2 * len(FIELDS)
    assert all(o.attrs["is_sparse"] == sparse
               and o.attrs["is_distributed"] is False for o in looks)
    assert [o.type for o in ops].count("lookup_table_grad") == 2 * len(FIELDS)
    types = {o.type for o in ops}
    assert {"log_loss", "pow", "sum", "adam"} <= types
    assert ("auc" in types) == (mode == "auc")
    if mode == "auc":
        assert len(outs) == 5


@pytest.mark.parametrize("is_sparse", [False, True])
def test_deepfm_trains_like_reference_over_adam_steps(is_sparse):
    """tests/test_book.py's DeepFM run (Adam 0.02, 12 steps, the same
    feed) from the reference's startup arrays: every loss within 1e-5
    relative, falling; the final pred in [0, 1]; the tables, fc weights
    and Adam moments (lazy Adam with is_sparse) as the reference's."""
    adam = lambda pkg: pkg.optimizer.Adam(0.02)  # noqa: E731
    r_main, r_start, r_outs, _ = build_deepfm(fluid, ref_deepfm, is_sparse,
                                              adam)
    p_main, _, p_outs, _ = build_deepfm(ptt, port_deepfm, is_sparse, adam)
    feeds = [narrow_feed(4)] * 12
    init, r_runs, final, _ = run_reference(r_main, r_start,
                                           [r_outs[1], r_outs[2]], feeds)
    runs, scope, _ = run_port(p_main, init, [p_outs[1], p_outs[2]], feeds)
    losses = [float(r[0].sum()) for r in runs]
    np.testing.assert_allclose(losses, [float(r[0].sum()) for r in r_runs],
                               rtol=1e-5)
    assert losses[-1] < losses[0]
    pred = runs[-1][1]
    assert pred.shape == (BATCH, 1) and (pred >= 0).all() and (pred <= 1).all()
    np.testing.assert_allclose(pred, r_runs[-1][1], rtol=1e-5, atol=1e-6)
    assert assert_state_close(final, scope, init) > len(final) // 2


def test_deepfm_streaming_auc_matches_reference():
    """with_auc (tests/test_book.py's second DeepFM run: batch 64, Adam
    0.05): the global and the 20-batch sliding AUC each step equal the
    reference's, and so do the four histograms after 5 steps up to a
    count moved to a neighbouring bucket: a prediction within float
    rounding of a bucket edge (1/4095) may land on either side (the
    auc op alone, on the same inputs, is exact: test_torch_core_api)."""
    adam = lambda pkg: pkg.optimizer.Adam(0.05)  # noqa: E731
    r_main, r_start, r_outs, _ = build_deepfm(fluid, ref_deepfm, False, adam,
                                              with_auc=True)
    p_main, _, p_outs, _ = build_deepfm(ptt, port_deepfm, False, adam,
                                        with_auc=True)
    feeds = [narrow_feed(9, batch=64)] * 5
    init, r_runs, final, _ = run_reference(
        r_main, r_start, [r_outs[1], r_outs[3], r_outs[4]], feeds)
    runs, scope, _ = run_port(p_main, init, [p_outs[1], p_outs[3],
                                             p_outs[4]], feeds)
    got = np.array([[float(v.sum()) for v in r] for r in runs])
    want = np.array([[float(v.sum()) for v in r] for r in r_runs])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ((got[:, 1:] >= 0) & (got[:, 1:] <= 1)).all()
    assert got[-1, 1] > 0.5  # the model overfits its one batch
    stats = [n for n in final if "auc" in n]
    assert len(stats) == 4
    for n in stats:
        got_h, want_h = scope.find_var(n).numpy(), final[n]
        assert got_h.sum() == want_h.sum()  # integer counts
        assert np.abs(np.cumsum(got_h - want_h, axis=-1)).max() <= 2, n


def _grad_values(main, feed, names, sparse):
    """One step's gradient values by name, taken inside the runner:
    each lookup_table_grad's W@GRAD as the optimizer op receives it."""
    from paddle_tpu_torch.core import registry

    seen = {}
    opdef = registry.OPS["lookup_table_grad"]
    lower = opdef.lower

    def spy(ctx, ins, attrs):
        out = lower(ctx, ins, attrs)
        seen[len(seen)] = out["W@GRAD"][0]
        return out

    opdef.lower = spy
    try:
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(main, feed=feed, fetch_list=names)
    finally:
        opdef.lower = lower
    return [seen[i] for i in range(len(seen))]


def test_sparse_tables_train_by_selected_rows_and_equal_dense_adagrad():
    """With is_sparse, every table's gradient reaches Adagrad as a
    SelectedRows of the batch's ids (batch rows, never [vocab, dim]);
    sparse and dense Adagrad (0.01, bench.py's) agree within 1e-6 over 3
    steps, an untouched row's dense update being exactly zero; and
    run_loop(3) equals 3 runs bit for bit."""
    fields = [1000, 5, 300]
    feed = narrow_feed(2, batch=64, fields=fields)
    ada = lambda pkg: pkg.optimizer.Adagrad(0.01)  # noqa: E731
    results = {}
    for sparse in (True, False):
        main, start, outs, _ = build_deepfm(ptt, port_deepfm, sparse, ada,
                                            fields=fields, embed_dim=16)
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            ptt.Executor(ptt.CPUPlace()).run(start)
            init = {n: scope.find_var(n).clone() for n in persistables(start)}
            grads = _grad_values(main, feed, [outs[1]], sparse)
            assert len(grads) == 2 * len(fields)
            for g in grads:
                assert isinstance(g, SelectedRows) == sparse
                if sparse:
                    assert tuple(g.rows.shape) == (64,)
            for n, v in init.items():
                scope.set(n, v.clone())
            exe = ptt.Executor(ptt.CPUPlace())
            losses = [float(exe.run(main, feed=feed,
                                    fetch_list=[outs[1]])[0].sum())
                      for _ in range(3)]
            results[sparse] = (losses, {n: scope.find_var(n).clone()
                                        for n in init})
            if sparse:  # run_loop(3) from the same state
                for n, v in init.items():
                    scope.set(n, v.clone())
                loop = ptt.Executor(ptt.CPUPlace()).run_loop(
                    3, main, feed=feed, fetch_list=[outs[1]])
                assert float(loop[0].sum()) == losses[-1]
                for n, v in results[True][1].items():
                    assert torch.equal(scope.find_var(n), v), n
    np.testing.assert_allclose(results[True][0], results[False][0],
                               rtol=1e-6)
    untouched = 0
    for n, v in results[True][1].items():
        np.testing.assert_allclose(v.numpy(), results[False][1][n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        if n.startswith("fm_v_0") and "moment" not in n:
            untouched = int((v == init[n]).all(dim=1).sum())
    ids = set(feed["C0"].ravel().tolist())
    assert untouched == 1000 - len(ids)  # untouched rows never moved
