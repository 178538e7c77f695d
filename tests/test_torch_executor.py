"""The port's compile-first executor on the CPU: cache entries
(``core/graph.py``), ``run_loop``, ``close``, ``host_feed_ms``, the
per-draw-site generators and the lowerings made capture-safe, against
the reference's executor where it has the same contract.

On the CPU an entry runs its step eagerly against its own buffers (feeds
staged into them, state copied into the scope's tensors), the same
buffer logic the card's CUDA graphs replay; the card's captures are
checked by ``chip_smoke.py``.

Tolerances: run_loop against the reference's run_loop at rtol 1e-5, the
training tests' (float32 sums in another order); everything within the
port bit for bit."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import gpt2 as ref_gpt2
from paddle_tpu.models import transformer as ref_tfm
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, layers, optimizer, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.core.registry import DrawSites, LowerCtx, get_op
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.models import transformer as port_tfm
from paddle_tpu_torch.parallel.mesh import Mesh
from paddle_tpu_torch.serving import Request, ServingEngine

SRC = TRG = 8
SEQ, BATCH = 16, 4


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


def _wmt(base, **kw):
    attrs = dict(src_vocab_size=53, trg_vocab_size=61, max_length=16,
                 d_model=32, d_inner_hid=64, n_head=4, n_layer=2, dropout=0.1)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


def _gpt2(base, **kw):
    attrs = dict(vocab_size=61, n_ctx=32, d_model=64, n_layer=2, n_head=4,
                 dropout=0.1)
    attrs.update(kw)
    return type("Tiny", (base,), attrs)


def _port_program(model, dropout=0.1):
    """(main, startup, loss, batch) of a tiny port training program."""
    if model == "wmt":
        hp = _wmt(port_tfm.ModelHyperParams, dropout=dropout)
        main, start, _, fetch = port_tfm.wmt_transformer_program(
            hp, src_len=SRC, trg_len=TRG, learning_rate=0.005,
            warmup_steps=2)
        batch = port_tfm.make_fake_batch(BATCH, SRC, TRG, hp, seed=2)
    else:
        hp = _gpt2(port_gpt2.GPT2Config, dropout=dropout)
        main, start, _, fetch = port_gpt2.gpt2_lm_program(hp, seq_len=SEQ,
                                                          lr=3e-3)
        batch = port_gpt2.make_fake_lm_batch(BATCH, SEQ, hp, seed=2)
    start.random_seed = main.random_seed = 3
    return main, start, fetch[0], batch


def _state(scope):
    return {n: scope.find_var(n).clone() for n in scope.local_var_names()}


# ---------------------------------------------------------------------------
# run_loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_run_loop_equals_sequential_runs_bit_for_bit(model):
    """Dropout 0.1: run_loop(4) reseeds each step with the step counter
    as 4 run() calls do, so its fetch equals the 4th run's and every
    persistable after it equals theirs, bit for bit."""
    main, start, loss, batch = _port_program(model)
    init_scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(start, scope=init_scope)
    init = _state(init_scope)
    results = []
    for loop in (False, True):
        scope = ptt.Scope()
        for n, v in init.items():
            scope.set(n, v.clone())
        exe = ptt.Executor(ptt.CPUPlace())
        if loop:
            out = [exe.run_loop(4, main, feed=batch, fetch_list=[loss],
                                scope=scope)[0]]
        else:
            out = [exe.run(main, feed=batch, fetch_list=[loss],
                           scope=scope)[0] for _ in range(4)]
        results.append((out, _state(scope)))
    (runs, s_runs), (looped, s_loop) = results
    assert len({float(v.sum()) for v in runs}) == 4  # the state moved
    np.testing.assert_array_equal(looped[0], runs[-1])
    assert sorted(s_runs) == sorted(s_loop)
    differ = [n for n in s_runs if not torch.equal(s_runs[n], s_loop[n])]
    assert not differ, differ[:5]
    moved = sum(not torch.equal(s_runs[n], init[n]) for n in init)
    assert moved > len(init) // 2


def _reference_loop(model):
    """The reference's tiny program at dropout 0: (startup arrays, its
    run_loop(4) fetch, its final arrays)."""
    if model == "wmt":
        hp = _wmt(ref_tfm.ModelHyperParams, dropout=0.0)
        main, start, _, fetch = ref_tfm.wmt_transformer_program(
            hp, src_len=SRC, trg_len=TRG, learning_rate=0.005,
            warmup_steps=2)
        batch = ref_tfm.make_fake_batch(BATCH, SRC, TRG, hp, seed=2)
    else:
        hp = _gpt2(ref_gpt2.GPT2Config, dropout=0.0)
        main, start, _, fetch = ref_gpt2.gpt2_lm_program(hp, seq_len=SEQ,
                                                         lr=3e-3)
        batch = ref_gpt2.make_fake_lm_batch(BATCH, SEQ, hp, seed=2)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(start)
        names = [n for n, v in start.global_block().vars.items()
                 if v.persistable]
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        got = exe.run_loop(4, main, feed=batch, fetch_list=[fetch[0]])[0]
        final = {n: np.asarray(scope.find_var(n)) for n in names}
    return init, np.asarray(got), final, batch


@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_run_loop_matches_the_reference_run_loop(model):
    """Dropout 0: the port's run_loop(4) from the reference's startup
    arrays gives the reference's run_loop(4) fetch, the 4th step's loss
    (rtol 1e-5), and both moved every parameter."""
    init, want, r_final, batch = _reference_loop(model)
    main, _, loss, _ = _port_program(model, dropout=0.0)
    scope = ptt.Scope()
    params_from_numpy(init, scope, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    got = exe.run_loop(4, main, feed=batch, fetch_list=[loss], scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    params = [p.name for p in main.global_block().all_parameters()
              if p.trainable]
    for name in params:
        assert not np.array_equal(scope.find_var(name).numpy(), init[name])
        assert not np.array_equal(r_final[name], init[name])


def test_run_loop_refuses_what_the_reference_refuses():
    main, start, loss, batch = _port_program("wmt")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    with pytest.raises(ValueError, match="positive"):
        exe.run_loop(0, main, feed=batch, fetch_list=[loss])
    host = ptt.Program()
    with ptt.program_guard(host, ptt.Program()):
        x = layers.data("x", shape=[3], append_batch_size=False)
        host.global_block().append_op("read", inputs={},
                                      outputs={"Out": [x]})
    with pytest.raises(ValueError, match="host-boundary"):
        exe.run_loop(2, host, fetch_list=[x])
    main._spmd = {"mesh": Mesh(("dp", "mp"), (1, 2), (0, 0), {}),
                  "rules": None}
    with pytest.raises(ValueError, match="spans ranks"):
        exe.run_loop(2, main, feed=batch, fetch_list=[loss])


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------
def test_draw_sites_draw_what_fresh_generators_draw():
    """A draw site's generator, reseeded per run, gives the fresh
    generator's numbers; a second draw at the same (kind, value) (a grad
    op's re-run of its forward op's draw) has a generator of its own and
    gives the same numbers again; a replay's reseed gives a run's."""
    sites = DrawSites(torch.device("cpu"))
    for seed in (5, 6):
        fresh = LowerCtx(seed=seed, device="cpu")
        kept = LowerCtx(seed=seed, device="cpu", draws=sites)
        sites.start()
        for op_idx in (3, 3, 7):  # the forward's draw, its grad's, another
            fresh.op_idx = kept.op_idx = op_idx
            want = torch.rand(64, generator=fresh.rng({}))
            got = torch.rand(64, generator=kept.rng({}))
            assert torch.equal(got, want)
        assert len(sites.gens) == 3
    sites.reseed(5)
    replayed = [torch.rand(64, generator=g) for g in sites.gens]
    first = LowerCtx(seed=5, device="cpu")
    first.op_idx = 3
    assert torch.equal(replayed[0], torch.rand(64, generator=first.rng({})))
    assert torch.equal(replayed[0], replayed[1])
    sites.start()
    kept = LowerCtx(seed=5, device="cpu", draws=sites)
    kept.op_idx = 4
    with pytest.raises(RuntimeError, match="changed"):
        kept.rng({})


def test_entry_draws_equal_eager_draws_and_grads_redraw_the_mask():
    """Dropout 0.1 on the tiny WMT step: the same step from the same
    state, once through its cache entry and once eagerly with fresh
    generators (use_program_cache=False), at the same step counter,
    draws the same masks; in each, every dropout_grad's X@GRAD is its
    Out@GRAD times its forward op's Mask."""
    main, start, loss, batch = _port_program("wmt")
    block = main.global_block()
    names = []
    for op in block.ops:
        if op.type == "dropout_grad":
            fwd = block.ops[op.attrs["__fwd_op_idx__"]]
            names += [fwd.outputs["Mask"][0], op.inputs["Out@GRAD"][0],
                      op.outputs["X@GRAD"][0]]
    assert names
    init_scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(start, scope=init_scope)
    init = _state(init_scope)
    runs = []
    for cached in (True, False):
        scope = ptt.Scope()
        for n, v in init.items():
            scope.set(n, v.clone())
        exe = ptt.Executor(ptt.CPUPlace())
        runs.append([exe.run(main, feed=batch, fetch_list=[loss] + names,
                             scope=scope, use_program_cache=cached)
                     for _ in range(2)])
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        vals = a[1:]
        for i in range(0, len(vals), 3):
            mask, dout, dx = vals[i:i + 3]
            assert 0.0 < mask.mean() < 1.0
            np.testing.assert_array_equal(dx, dout * mask)
    assert not np.array_equal(runs[0][0][1], runs[0][1][1])  # new step, new mask


# ---------------------------------------------------------------------------
# the entries' buffers
# ---------------------------------------------------------------------------
def _scaled_program():
    """y = x * w, w a persistable [3]."""
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = layers.data("x", shape=[3], append_batch_size=False)
        w = layers.create_parameter([3], "float32", name="w")
        y = layers.elementwise_mul(x, w)
    return main, y


def test_scope_set_between_runs_reaches_the_next_run():
    main, y = _scaled_program()
    scope = ptt.Scope()
    scope.set("w", torch.tensor([1.0, 2.0, 3.0]))
    exe = ptt.Executor(ptt.CPUPlace())
    x = np.array([1.0, 1.0, 2.0], "float32")
    np.testing.assert_array_equal(
        exe.run(main, feed={"x": x}, fetch_list=[y], scope=scope)[0],
        [1.0, 2.0, 6.0])
    held = scope.find_var("w")
    scope.set("w", torch.tensor([-1.0, 0.5, 4.0]))
    np.testing.assert_array_equal(
        exe.run(main, feed={"x": x}, fetch_list=[y], scope=scope)[0],
        [-1.0, 0.5, 8.0])
    # the value went into the entry's tensor, which the scope holds again
    assert scope.find_var("w") is held
    assert torch.equal(held, torch.tensor([-1.0, 0.5, 4.0]))
    scope.set("w", np.array([2.0, 2.0, 2.0], "float32"))  # a numpy load
    np.testing.assert_array_equal(
        exe.run(main, feed={"x": x}, fetch_list=[y], scope=scope)[0],
        [2.0, 2.0, 4.0])
    assert exe.compile_count == 1


def test_fetched_tensors_survive_the_next_run():
    """return_numpy=False: a run's fetches (the loss, an updated
    parameter, a feed) are copies, unchanged by the next run."""
    main, start, loss, batch = _port_program("gpt2")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    param = main.global_block().all_parameters()[0].name
    first = exe.run(main, feed=batch, fetch_list=[loss, param, "ids"],
                    return_numpy=False)
    kept = [t.clone() for t in first]
    batch2 = dict(batch, ids=(batch["ids"] + 1) % 61)
    second = exe.run(main, feed=batch2, fetch_list=[loss, param, "ids"],
                     return_numpy=False)
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(first[1], second[1])  # Adam moved the parameter
    assert not torch.equal(first[2], second[2])
    assert not any(a.data_ptr() == b.data_ptr()
                   for a, b in zip(first, second))
    assert exe.compile_count == 2  # the startup's entry and the step's


def _adam_program_with_a_backup():
    """A [4, 3] @ w [3, 2] loss with Adam on w, and a startup that copies
    w's initial value into the persistable w_backup by ``assign``."""
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = layers.data("x", shape=[4, 3], append_batch_size=False)
        w = layers.create_parameter([3, 2], "float32", name="w")
        loss = layers.mean(layers.matmul(x, w))
        optimizer.Adam(0.1).minimize(loss)
    with ptt.program_guard(start, ptt.Program()):
        backup = start.global_block().create_var(
            name="w_backup", shape=[3, 2], dtype="float32", persistable=True)
        layers.assign(start.global_block().var("w"), output=backup)
    start.random_seed = 7
    return main, start, loss


@pytest.mark.parametrize("cached", [True, False])
def test_an_aliasing_startup_assign_leaves_each_var_its_own_tensor(cached):
    """``assign`` returns its input, so the startup leaves one value under
    w and w_backup: the commit gives w_backup a copy of its own, and an
    Adam step's update of w in place does not reach it, as the
    reference's fresh arrays do not."""
    main, start, loss = _adam_program_with_a_backup()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope, use_program_cache=cached)
    w, backup = scope.find_var("w"), scope.find_var("w_backup")
    assert w.untyped_storage().data_ptr() != \
        backup.untyped_storage().data_ptr()
    init = w.clone()
    assert torch.equal(backup, init)
    x = np.arange(12, dtype="float32").reshape(4, 3)
    exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope,
            use_program_cache=cached)
    assert not torch.equal(scope.find_var("w"), init)  # Adam moved w
    assert torch.equal(scope.find_var("w_backup"), init)


def test_a_tensor_set_under_two_names_is_split_before_an_update():
    """A user's scope.set of one tensor under w and w_backup: the entry
    gives the updated w a copy of its own before its first run, so the
    update in place leaves w_backup (and the caller's tensor) as they
    were; later runs keep w's tensor."""
    main, start, loss = _adam_program_with_a_backup()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope)
    shared = scope.find_var("w").clone()
    kept = shared.clone()
    scope.set("w", shared)
    scope.set("w_backup", shared)
    x = np.arange(12, dtype="float32").reshape(4, 3)
    exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    assert scope.find_var("w_backup") is shared
    assert torch.equal(shared, kept)
    moved = scope.find_var("w")
    assert not torch.equal(moved, kept)
    exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    assert scope.find_var("w") is moved  # updated in place from now on
    assert torch.equal(shared, kept)


def test_a_new_feed_shape_makes_an_entry_and_new_values_do_not():
    main, y = _scaled_program()
    scope = ptt.Scope()
    scope.set("w", torch.ones(3))
    exe = ptt.Executor(ptt.CPUPlace())
    for v in (1.0, 2.0, 3.0):
        exe.run(main, feed={"x": np.full(3, v, "float32")}, fetch_list=[y],
                scope=scope)
    assert exe.compile_count == 1
    exe.run(main, feed={"x": np.full(3, 1, "int64").astype("float64")},
            fetch_list=[y], scope=scope)  # float64 feeds go in as float32
    assert exe.compile_count == 1
    # a new shape: x is declared [3], but the feed signature keys the
    # entry, as the reference's jit cache does
    exe.run(main, feed={"x": np.ones((1, 3), "float32")}, fetch_list=[y],
            scope=scope)
    assert exe.compile_count == 2
    exe.run(main, feed={"x": np.ones(3, "float32")}, fetch_list=[y],
            scope=scope, use_program_cache=False)  # eager: no entry
    assert exe.compile_count == 2


def test_a_state_var_of_a_new_shape_renews_the_entry():
    main, y = _scaled_program()
    scope = ptt.Scope()
    scope.set("w", torch.ones(3))
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(main, feed={"x": np.ones(3, "float32")}, fetch_list=[y],
            scope=scope)
    scope.set("w", torch.full((1,), 2.0))  # broadcasts against x
    got = exe.run(main, feed={"x": np.ones(3, "float32")}, fetch_list=[y],
                  scope=scope)[0]
    np.testing.assert_array_equal(got, [2.0, 2.0, 2.0])
    assert exe.compile_count == 2


def test_compile_count_holds_across_a_serving_churn_trace():
    """The engine's pooled step, slot reset and cache startup each make
    one entry at their first run; the churn after that (slots admitted,
    evicted, prefilling, decoding) changes feed values only."""
    hp = _gpt2(port_gpt2.GPT2Config, dropout=0.0)
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        _, start, _, _ = port_gpt2.gpt2_logits_program(hp, seq_len=24)
        start.random_seed = 5
        exe.run(start)
        eng = ServingEngine(exe, hp, n_slots=3, width=4, t_max=24)
        rng = np.random.RandomState(0)
        trace = [Request(rid=i, prompt=rng.randint(1, 61, int(rng.randint(
            2, 11))), max_new_tokens=int(rng.randint(3, 9)),
            arrival=float(i) * 0.7) for i in range(7)]
        run = exe.run
        counts = []

        def counting(program=None, **kw):
            out = run(program, **kw)
            counts.append((program, exe.compile_count))
            return out

        exe.run = counting
        results, stats = eng.run(trace)
        first = next(i for i, (p, _) in enumerate(counts)
                     if p is eng.step_main)
        assert any(p is eng.reset_prog for p, _ in counts[:first + 1])
        assert {c for _, c in counts[first:]} == {4}
        assert stats["compile_count"] == 4
        assert stats["steps"] > len(trace)
        assert all(r["status"] == "OK" for r in results.values())
        solo, _ = eng.run_solo(trace[3])
        np.testing.assert_array_equal(solo, results[3]["tokens"])
        assert exe.compile_count == 4


# ---------------------------------------------------------------------------
# close, host_feed_ms
# ---------------------------------------------------------------------------
def test_close_frees_the_entries_and_later_runs_raise():
    main, start, loss, batch = _port_program("wmt")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    exe.run(main, feed=batch, fetch_list=[loss])
    exe.close()
    assert not exe._entries
    with pytest.raises(RuntimeError, match="closed"):
        exe.run(main, feed=batch, fetch_list=[loss])
    with pytest.raises(RuntimeError, match="closed"):
        exe.run_loop(2, main, feed=batch, fetch_list=[loss])
    ref = fluid.Executor(fluid.CPUPlace())
    ref.close()
    with pytest.raises(RuntimeError, match="closed"):
        ref.run(fluid.Program())


def test_host_feed_ms_grows_with_fed_runs_only():
    main, start, loss, batch = _port_program("wmt")
    exe = ptt.Executor(ptt.CPUPlace())
    assert exe.host_feed_ms == 0.0
    exe.run(start)
    assert exe.host_feed_ms == 0.0
    exe.run(main, feed=batch, fetch_list=[loss])
    after_one = exe.host_feed_ms
    assert after_one > 0.0
    exe.run(main, feed=batch, fetch_list=[loss], use_program_cache=False)
    after_two = exe.host_feed_ms
    assert after_two > after_one
    exe.run(start)
    assert exe.host_feed_ms == after_two
    exe.run_loop(2, main, feed=batch, fetch_list=[loss])
    assert exe.host_feed_ms > after_two


def test_spmd_comm_stats_is_empty_without_collectives():
    main, start, loss, batch = _port_program("wmt")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    exe.run(main, feed=batch, fetch_list=[loss])
    assert exe.spmd_comm_stats(main) == {"per_op": {}, "total_bytes": 0}


# ---------------------------------------------------------------------------
# the lowerings made capture-safe: the same values as before
# ---------------------------------------------------------------------------
def _lower(op_type, ins, attrs, ctx=None):
    return get_op(op_type).lower(ctx or LowerCtx(device="cpu"), ins, attrs)


def test_assign_value_makes_its_constant_once_and_returns_copies():
    attrs = {"values": [1.5, -2.0, 3.25, 0.0], "shape": [2, 2],
             "np_dtype": "float32"}
    ctx = LowerCtx(device="cpu")
    first = _lower("assign_value", {}, attrs, ctx)["Out"][0]
    want = torch.from_numpy(np.array(attrs["values"], "float32").reshape(2, 2))
    assert torch.equal(first, want) and first.dtype == torch.float32
    first.add_(100.0)  # an in-place write downstream
    second = _lower("assign_value", {}, attrs, ctx)["Out"][0]
    assert torch.equal(second, want)
    assert len(ctx.consts) == 1
    ints = _lower("assign_value", {}, {"values": [3, 4], "np_dtype": "int64"})
    assert torch.equal(ints["Out"][0], torch.tensor([3, 4]))


@pytest.mark.parametrize("dtype,step", [(torch.float32, 1.0),
                                        (torch.float32, 2.5),
                                        (torch.int64, 1.0),
                                        (torch.int32, 3.0)])
def test_increment_adds_the_step_in_the_dtype_of_x(dtype, step):
    x = torch.arange(5).to(dtype) * 7
    got = _lower("increment", {"X": [x]}, {"step": step})["Out"][0]
    want = x + torch.tensor(step, dtype=dtype)  # the old lowering
    assert got.dtype == dtype and torch.equal(got, want)


def test_clip_and_the_xent_floor_keep_their_values_and_tie_gradients():
    """Bounds as device constants (torch.full) in place of host copies:
    the same values, and a tie at a bound still splits its derivative
    0.5 / 0.5, as the reference's jnp.clip does."""
    x = torch.tensor([-2.0, -1.0, 0.3, 1.0, 4.0], requires_grad=True)
    out = _lower("clip", {"X": [x]}, {"min": -1.0, "max": 1.0})["Out"][0]
    lo, hi = torch.tensor(-1.0), torch.tensor(1.0)
    want = torch.minimum(torch.maximum(x, lo), hi)
    assert torch.equal(out, want)
    (g,) = torch.autograd.grad(out.sum(), x)
    assert torch.equal(g, torch.tensor([0.0, 0.5, 1.0, 0.5, 0.0]))
    p = torch.tensor([[0.0, 1.0], [1e-30, 0.5]], requires_grad=True)
    lbl = torch.tensor([[0], [0]])
    y = _lower("cross_entropy", {"X": [p], "Label": [lbl]}, {})["Y"][0]
    floor = torch.tensor(1e-20)
    want = -torch.log(torch.maximum(p[:, :1], floor))
    assert torch.equal(y, want)
    assert float(y[0].detach()) == float(-np.log(np.float32(1e-20)))
