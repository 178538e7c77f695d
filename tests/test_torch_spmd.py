"""The port's vocab-parallel slice on the CPU: the partition-rule
registry, sharded_linear_xent (B12) per shard and combined over two gloo
ranks, and tiny WMT and GPT-2 training programs run on a {"dp": 1,
"mp": 2} mesh whose rule table vocab-shards softmax_out.w, each against
the reference's run of the same on two virtual devices.

The rank workers are module-level functions started with the `spawn`
method: a rank imports this module to find its target, so jax and
paddle_tpu are imported inside the test functions only.  All two-rank
work runs in ONE spawn (the `ranks` fixture), each test reading its
part of the result.  Rendezvous goes through a file in a temp dir, not
a TCP port, since several test workers run side by side.

Tolerances: 1e-5 (rtol and atol) for the per-shard plain versions
against the Pallas kernels and for the combine against the reference
and the unsharded kernel (float32 sums in another order); losses within
1e-5 relative and softmax_out.w and its Adam moments within 1e-5 of the
largest magnitude over 3 Adam steps; replicated persistables bit-equal
across the ranks after every step (each rank computes the same sums of
the same values).

The WMT program trains at its own schedule (noam, warmup 4000), whose
first steps take a rate near 1e-6.  Adam's first steps move every
element by about the rate whatever its gradient's size, so at a large
rate the float32 reassociation noise of a near-zero gradient becomes a
weight error in proportion to the rate (the tiny WMT config at a rate
near 0.03 differs from the reference by 1.3e-4 of the largest
magnitude); the
Adam moments (0.1 g and 0.001 g^2 after a step) hold the sharded
gradients themselves to 1e-5."""

import hashlib
import multiprocessing
import os
import pickle
import tempfile
import traceback

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.executor import gather_persistable
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.kernels import fused_linear_xent
from paddle_tpu_torch.kernels.sharded_linear_xent import (
    linear_xent_grad_sharded_plain,
    linear_xent_parts_plain,
    sharded_linear_xent,
)
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.models import transformer as port_tfm
from paddle_tpu_torch.parallel import (
    P,
    TrainPartitionRules,
    annotate_spmd,
    collective,
    make_mesh,
    train_partition_rules_for,
)
from paddle_tpu_torch.parallel.mesh import Mesh

SRC = TRG = 8
BATCH = 4
STEPS = 3
GPT2_LR = 3e-3  # the reference's spmd training tests' rate
VOCAB_RULE = [(r"softmax_out\.w", P(None, "mp"))]
# combine inputs: R rows, H hidden, V vocab over 2 shards
CR, CH, CV = 20, 16, 48


def _wmt_hp(base):
    return type("TinyWMT", (base,), dict(
        src_vocab_size=64, trg_vocab_size=64, max_length=16, d_model=32,
        d_inner_hid=64, n_head=4, n_layer=2, dropout=0.0))


def _gpt2_hp(base, vocab=64):
    return type("TinyGPT2", (base,), dict(
        vocab_size=vocab, n_ctx=16, d_model=32, n_layer=2, n_head=4,
        d_inner=64, dropout=0.0, tie_embeddings=False))


def _program(pkg_tfm, pkg_gpt2, model, mesh, vocab=64):
    """(main, startup, loss var, batch) of `model` built by one package."""
    if model == "wmt":
        hp = _wmt_hp(pkg_tfm.ModelHyperParams)
        main, start, _, fetch = pkg_tfm.wmt_transformer_program(
            hp, src_len=SRC, trg_len=TRG, mesh=mesh)
        return main, start, fetch[0], pkg_tfm.make_fake_batch(
            BATCH, SRC, TRG, hp, seed=0)
    hp = _gpt2_hp(pkg_gpt2.GPT2Config, vocab)
    main, start, _, fetch = pkg_gpt2.gpt2_lm_program(
        hp, seq_len=SRC, lr=GPT2_LR, mesh=mesh)
    return main, start, fetch[0], pkg_gpt2.make_fake_lm_batch(
        BATCH, SRC, hp, seed=0)


def _vocab_names(names):
    """softmax_out.w and its two Adam moments, in that order."""
    w = [n for n in names if n.startswith("softmax_out.w")
         and "moment" not in n and "pow" not in n]
    return w + sorted(n for n in names if n.startswith("softmax_out.w")
                      and "moment" in n)


# ---------------------------------------------------------------------------
# rank workers (module level: a spawned rank imports this module)
# ---------------------------------------------------------------------------
def _digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _train_rank(model, mesh, init, vocab=64):
    """3 Adam steps of `model` from the carried weights under the
    vocab-only table: losses, a digest of every replicated persistable
    after every step, the gathered softmax_out.w and moments, and the
    fetched softmax_out.w."""
    unique_name.switch()
    main, start, loss, batch = _program(port_tfm, port_gpt2, model, mesh,
                                        vocab)
    annotate_spmd(main, mesh, TrainPartitionRules(VOCAB_RULE))
    scope = ptt.Scope()
    out = {"losses": [], "replicated": [], "comm": []}
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        exe = ptt.Executor(ptt.CPUPlace())
        names = _vocab_names(init)
        for step in range(STEPS):
            fetch = [loss] + (names[:1] if step == STEPS - 1 else [])
            got = exe.run(main, feed=batch, fetch_list=fetch)
            out["losses"].append(float(np.asarray(got[0]).sum()))
            out["comm"].append(exe.spmd_comm_stats(main))
            out["replicated"].append({
                n: _digest(scope.find_var(n)) for n in sorted(init)
                if n not in names})
        out["fetched_w"] = got[1]
        out["gathered"] = [gather_persistable(scope, main, n).numpy()
                           for n in names]
        out["held"] = {n: tuple(scope.find_var(n).shape) for n in names}
    return out


def _combine_rank(rank, inputs):
    """sharded_linear_xent on this rank's slab under torch.func.vjp:
    (loss, dx, dw slab) for each eps."""
    x, w, labels, dy = (torch.from_numpy(inputs[k])
                        for k in ("x", "w", "labels", "dy"))
    vl = CV // 2
    wl = w[:, rank * vl:(rank + 1) * vl].contiguous()
    group = make_mesh({"dp": 1, "mp": 2}).group("mp")
    res = {}
    for eps in (0.0, 0.1):
        loss, vjp = torch.func.vjp(
            lambda a, b: sharded_linear_xent(a, b, labels, eps, group,
                                             rank * vl, CV), x, wl)
        dx, dw = vjp(dy)
        res[eps] = (loss.numpy(), dx.numpy(), dw.numpy())
    return res


def _odd_vocab_rank(mesh, init):
    """GPT-2 with vocab 63 on mp 2 under the vocab-only table: the
    divisibility guard keeps softmax_out.w whole, and the op runs the
    unsharded kernel.  Counts the calls of both."""
    from paddle_tpu_torch.ops import math_ops, spmd_epilogue

    calls = {"fused": 0, "sharded": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    math_ops.fused_linear_xent = spy("fused", math_ops.fused_linear_xent)
    spmd_epilogue.sharded_linear_xent = spy(
        "sharded", spmd_epilogue.sharded_linear_xent)
    unique_name.switch()
    main, start, loss, batch = _program(port_tfm, port_gpt2, "gpt2", mesh,
                                        vocab=63)
    rules = TrainPartitionRules(VOCAB_RULE)
    annotate_spmd(main, mesh, rules)
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        got = ptt.Executor(ptt.CPUPlace()).run(main, feed=batch,
                                               fetch_list=[loss])
        wname = _vocab_names(init)[0]
        held = tuple(scope.find_var(wname).shape)
    return {"calls": calls, "held": held, "loss": float(got[0].sum()),
            "replicated_log": list(rules.replicated_log)}


def _raises(fn):
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return None


def _unported_rank(mesh, inits):
    """The messages of what a two-rank job may not run yet: the default
    transformer and gpt2 tables at mp 2, and a dp axis of 2."""
    msgs = {}
    for model in ("wmt", "gpt2"):
        unique_name.switch()
        main, _, loss, batch = _program(port_tfm, port_gpt2, model, mesh)
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            params_from_numpy(inits[model], scope, ptt.CPUPlace())
            msgs[model] = _raises(lambda: ptt.Executor(ptt.CPUPlace()).run(
                main, feed=batch, fetch_list=[loss]))
    dp_mesh = make_mesh({"dp": 2, "mp": 1})
    unique_name.switch()
    main, _, loss, batch = _program(port_tfm, port_gpt2, "wmt", dp_mesh)
    annotate_spmd(main, dp_mesh, TrainPartitionRules(VOCAB_RULE))
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        params_from_numpy(inits["wmt"], scope, ptt.CPUPlace())
        msgs["dp2"] = _raises(lambda: ptt.Executor(ptt.CPUPlace()).run(
            main, feed=batch, fetch_list=[loss]))
    return msgs


def _rank_main(rank, store, job, out_dir):
    """One rank of the two-rank CPU job: every part of `job`, in the
    same order on both ranks; the results (or the traceback) pickled to
    out_dir/rank<r>.pkl."""
    path = os.path.join(out_dir, "rank%d.pkl" % rank)
    try:
        collective.init_distributed_env("file://" + store, 2, rank,
                                        backend="gloo")
        out = {"combine": _combine_rank(rank, job["combine"])}
        mesh = make_mesh({"dp": 1, "mp": 2})
        out["coord"] = mesh.coord
        for model in ("wmt", "gpt2"):
            out[model] = _train_rank(model, mesh, job["init"][model])
        out["odd_vocab"] = _odd_vocab_rank(mesh, job["init"]["gpt2_63"])
        out["unported"] = _unported_rank(mesh, job["init"])
        collective.barrier()
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump({"error": traceback.format_exc()}, f)
        raise
    with open(path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the reference's side (in the test process)
# ---------------------------------------------------------------------------
def _ref_vocab_parallel(model, vocab=64, steps=STEPS):
    """The reference's run of `model` with use_pallas on a {"dp": 1, "mp":
    2} mesh of 2 virtual devices, re-stamped with the vocab-only table:
    (startup arrays, losses, final arrays)."""
    import jax

    import paddle_tpu as fluid
    from paddle_tpu import flags
    from paddle_tpu.models import gpt2 as ref_gpt2
    from paddle_tpu.models import transformer as ref_tfm
    from paddle_tpu.parallel import make_mesh as ref_make_mesh
    from paddle_tpu.parallel.partition_rules import (
        P as RP,
        TrainPartitionRules as RTrain,
        annotate_spmd as ref_annotate,
    )

    old = {k: flags.get_flag(k) for k in ("use_pallas", "kernel_autotune")}
    flags.set_flags({"use_pallas": True, "kernel_autotune": False})
    try:
        mesh = ref_make_mesh({"dp": 1, "mp": 2}, devices=jax.devices()[:2])
        main, start, loss, batch = _program(ref_tfm, ref_gpt2, model, mesh,
                                            vocab)
        ref_annotate(main, mesh, RTrain([(r"softmax_out\.w",
                                          RP(None, "mp"))]))
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(start)
            names = [n for n, v in start.global_block().vars.items()
                     if v.persistable]
            init = {n: np.asarray(scope.find_var(n)) for n in names}
            losses = [float(np.asarray(exe.run(
                main, feed=batch, fetch_list=[loss])[0]).sum())
                for _ in range(steps)]
            final = {n: np.asarray(scope.find_var(n)) for n in names}
    finally:
        flags.set_flags(old)
    return init, losses, final


def _combine_inputs():
    rng = np.random.RandomState(11)
    labels = rng.randint(0, CV, CR).astype("int64")
    labels[:4] = [-1, CV, 3, CV // 2 + 5]  # invalid, invalid, shard 0, 1
    return {"x": rng.randn(CR, CH).astype("float32"),
            "w": (rng.randn(CH, CV) * CH ** -0.5).astype("float32"),
            "labels": labels,
            "dy": rng.rand(CR, 1).astype("float32")}


def _ref_combine(inputs):
    """pk.sharded_linear_xent inside shard_map on 2 virtual devices,
    under jax.vjp: {eps: (loss, dx, dw)} with dw the full [H, V]."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_kernels as pk
    from paddle_tpu.parallel import make_mesh as ref_make_mesh
    from paddle_tpu.parallel.mesh import shard_map
    from jax.sharding import PartitionSpec as JP

    mesh = ref_make_mesh({"mp": 2}, devices=jax.devices()[:2])
    x, w = jnp.asarray(inputs["x"]), jnp.asarray(inputs["w"])
    labels = jnp.asarray(inputs["labels"]).astype(jnp.int32)
    br, bv = pk._lxent_default_blocks(CR, CH, CV // 2)
    out = {}
    for eps in (0.0, 0.1):
        def body(xl, wl, ll, eps=eps):
            return pk.sharded_linear_xent(xl, wl, ll, eps, "mp", CV, br, bv)

        f = shard_map(body, mesh=mesh,
                      in_specs=(JP(None, None), JP(None, "mp"), JP(None)),
                      out_specs=JP(None, None), check_rep=False)
        loss, vjp = jax.vjp(lambda a, b: f(a, b, labels), x, w)
        dx, dw = vjp(jnp.asarray(inputs["dy"]))
        out[eps] = tuple(np.asarray(v) for v in (loss, dx, dw))
    return out


@pytest.fixture(scope="module")
def ranks():
    """The reference's runs, then ONE spawn of two gloo CPU ranks that
    run every two-rank part; returns (reference results, [rank 0,
    rank 1] results)."""
    ref = {"combine_inputs": _combine_inputs()}
    ref["combine"] = _ref_combine(ref["combine_inputs"])
    for model in ("wmt", "gpt2"):
        ref[model] = _ref_vocab_parallel(model)
    init_63 = _ref_vocab_parallel("gpt2", vocab=63, steps=0)[0]
    job = {"combine": ref["combine_inputs"],
           "init": {"wmt": ref["wmt"][0], "gpt2": ref["gpt2"][0],
                    "gpt2_63": init_63}}
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, os.path.join(d, "store"), job, d))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(240)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        assert not alive, "a rank hung"
        results = []
        for r in range(2):
            with open(os.path.join(d, "rank%d.pkl" % r), "rb") as f:
                results.append(pickle.load(f))
    for r, res in enumerate(results):
        assert "error" not in res, "rank %d failed:\n%s" % (r, res.get(
            "error"))
    assert [p.exitcode for p in procs] == [0, 0]
    return ref, results


# ---------------------------------------------------------------------------
# 1. the rule tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["wmt", "gpt2"])
@pytest.mark.parametrize("table", ["family", "vocab_only"])
def test_rules_resolve_like_the_reference(model, table):
    """Every persistable of the training program (params, grads, Adam
    moments and beta powers) resolves to the reference's spec, with its
    declared shape (the scalar and rank guards included), and the
    fallbacks log the same names for the same reasons."""
    from paddle_tpu.models import gpt2 as ref_gpt2
    from paddle_tpu.models import transformer as ref_tfm
    from paddle_tpu.parallel.partition_rules import (
        P as RP,
        TrainPartitionRules as RTrain,
        train_partition_rules_for as ref_rules_for,
    )

    family = "transformer" if model == "wmt" else "gpt2"
    if table == "family":
        ref_rules, port_rules = ref_rules_for(family), \
            train_partition_rules_for(family)
    else:
        ref_rules = RTrain([(r"softmax_out\.w", RP(None, "mp"))])
        port_rules = TrainPartitionRules(VOCAB_RULE)
    main = _program(ref_tfm, ref_gpt2, model, None)[0]
    block = main.global_block()
    names = sorted(n for n, v in block.vars.items() if v.persistable
                   or n.endswith("@GRAD"))
    assert any(n.endswith("@GRAD") for n in names)
    assert any("moment" in n for n in names)
    for n in names:
        shape = tuple(block.vars[n].shape)
        assert tuple(port_rules.spec_for(n, shape)) == tuple(
            ref_rules.spec_for(n, shape)), n
    assert [n for n, _ in port_rules.replicated_log] == [
        n for n, _ in ref_rules.replicated_log]


def test_rule_guards_and_registry():
    """The scalar guard (no log), the rank guard (logged), the
    divisibility guard of sharding_for on a mesh (logged; an axis of
    size 1 splits nothing), first-match precedence (pos_emb.w before
    emb.w), derived names, and the registry's KeyError."""
    from paddle_tpu.parallel.partition_rules import (
        partition_rules_for as ref_rules_for,
    )

    rules = train_partition_rules_for("gpt2")
    ref = ref_rules_for("gpt2")
    assert tuple(rules.spec_for("softmax_out.w_0_beta1_pow_acc_0", (1,))) == ()
    assert tuple(rules.spec_for("emb.w_0", (64, 32))) == ("mp", None)
    assert tuple(rules.spec_for("pos_emb.w_0", (16, 32))) == ()
    assert tuple(ref.spec_for("pos_emb.w_0", (16, 32))) == ()
    assert tuple(rules.spec_for("softmax_out.w_0_moment2_0", (32, 64))) == (
        None, "mp")
    assert tuple(rules.spec_for("softmax_out.w_0@GRAD", (32, 64))) == (
        None, "mp")
    assert tuple(rules.spec_for("ffn_in.b_0", ())) == ()
    assert rules.replicated_log == []
    assert tuple(rules.spec_for("mha_q.w_0", (32,))) == ()  # rank guard
    assert rules.replicated_log[-1][0] == "mha_q.w_0"
    assert tuple(rules.spec_for("layer_norm_0.w_0", (32,))) == ()
    assert rules.replicated_log[-1] == ("layer_norm_0.w_0", "no rule matched")
    mesh2 = Mesh(("dp", "mp"), (1, 2), (0, 1), {})
    sl = rules.sharding_for(mesh2, "softmax_out.w_0", (32, 64))
    assert (sl.dim, sl.axis, sl.index, sl.size, sl.start, sl.shape) == (
        1, "mp", 1, 32, 32, (32, 32))
    assert rules.sharding_for(mesh2, "softmax_out.w_0", (32, 63)) is None
    assert rules.replicated_log[-1] == ("softmax_out.w_0", "dim 63 !% mp=2")
    mesh1 = Mesh(("dp", "mp"), (1, 1), (0, 0), {})
    assert rules.sharding_for(mesh1, "mha_q.w_0", (32, 32)) is None
    with pytest.raises(KeyError, match="known: bert, gpt2, transformer"):
        train_partition_rules_for("resnet")


def test_make_mesh_without_a_process_group():
    """A mesh whose axes are all 1 needs no process group; any other
    mesh needs as many ranks as its sizes multiply to."""
    mesh = make_mesh({"dp": 1, "mp": 1})
    assert mesh.shape == {"dp": 1, "mp": 1} and mesh.coord == {"dp": 0,
                                                               "mp": 0}
    assert mesh.group("mp") is None and mesh.index("mp") == 0
    assert make_mesh({"dp": -1}).shape == {"dp": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh({"dp": 1, "mp": 2})
    x = torch.arange(3.0)
    for op in ("sum", "max", "min", "mean"):
        assert torch.equal(collective.all_reduce(x, None, op), x)
    assert torch.equal(collective.all_gather(x, None), x)
    assert torch.equal(collective.broadcast(x, None), x)


# ---------------------------------------------------------------------------
# 2. B12 per shard, against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
R1, H1, VL1 = 20, 16, 24  # R ragged against the row block 8; V/n for n 2


def _shard_case(shard, eps):
    rng = np.random.RandomState(5 + shard)
    x = rng.randn(R1, H1).astype("float32")
    w = (rng.randn(H1, VL1) * H1 ** -0.5).astype("float32")
    labels = rng.randint(0, 2 * VL1, R1).astype("int64")
    # inside this shard, in the other one (its first and last column: a
    # local label in the padded tail of a 16-wide tile), -1 and >= V
    labels[:5] = [shard * VL1 + 2, (1 - shard) * VL1, (2 - shard) * VL1 - 1,
                  -1, 2 * VL1]
    local = labels - shard * VL1
    valid = ((labels >= 0) & (labels < 2 * VL1)).astype("float32")
    lse = (rng.randn(R1, 1) + 4.0).astype("float32")
    dy = rng.rand(R1, 1).astype("float32")
    return x, w, local, valid, lse, dy


@pytest.mark.parametrize("blocks", ["default", (8, 16)])
@pytest.mark.parametrize("shard", [0, 1])
def test_parts_plain_matches_pallas(blocks, shard):
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_kernels as pk

    x, w, local, _, _, _ = _shard_case(shard, 0.0)
    br, bv = (pk._lxent_default_blocks(R1, H1, VL1) if blocks == "default"
              else blocks)
    want = pk._lxent_parts(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(local.astype("int32")), br, bv)
    got = linear_xent_parts_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(local))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("blocks", ["default", (8, 16)])
@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("shard", [0, 1])
def test_grad_sharded_plain_matches_pallas(blocks, eps, shard):
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_kernels as pk

    x, w, local, valid, lse, dy = _shard_case(shard, eps)
    br, bv = (pk._lxent_default_blocks(R1, H1, VL1) if blocks == "default"
              else blocks)
    want = pk._lxent_bwd_sharded(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(local.astype("int32")),
        jnp.asarray(valid), jnp.asarray(lse), jnp.asarray(dy), eps, 2 * VL1,
        br, bv)
    got = linear_xent_grad_sharded_plain(
        *(torch.from_numpy(a) for a in (x, w, local, valid, lse, dy)), eps,
        2 * VL1)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_sharded_wrappers_dispatch_by_device(monkeypatch):
    """CPU and meta tensors take the plain versions; a CUDA tensor
    launches (build.launch, monkeypatched here) or raises."""
    import importlib

    from paddle_tpu_torch.kernels import build

    slx = importlib.import_module(
        "paddle_tpu_torch.kernels.sharded_linear_xent")
    x, w, local, valid, lse, dy = (torch.from_numpy(a) for a in
                                   _shard_case(0, 0.1))
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: launched.append(name))
    before = slx.linear_xent_parts.launches
    slx.linear_xent_parts(x, w, local)
    slx.linear_xent_dx_sharded(x, w, local, valid, lse, dy, 0.1, 48)
    assert launched == [] and slx.linear_xent_parts.launches == before
    meta = [t.to("meta") for t in (x, w, local, valid, lse, dy)]
    shapes = [tuple(t.shape) for t in slx.linear_xent_parts(*meta[:3])]
    assert shapes == [(R1, 1)] * 3
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    slx.linear_xent_parts(x, w, local)
    slx.linear_xent_dx_sharded(x, w, local, valid.reshape(-1), lse, dy, 0.1,
                               48)
    slx.linear_xent_dw_sharded(x, w, local, valid.reshape(-1), lse, dy, 0.1,
                               48)
    assert launched == ["ptt_linear_xent_parts", "ptt_linear_xent_dx_sharded",
                        "ptt_linear_xent_dw_sharded"]
    assert slx.linear_xent_parts.launches == before + 1
    with pytest.raises(TypeError, match="int64"):
        slx.linear_xent_parts(x, w, local.int())


# ---------------------------------------------------------------------------
# 3. the combine and its vjp on two gloo ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_combine_matches_reference_and_unsharded(ranks, eps):
    """Both ranks' loss and dx equal the reference's shard_map run and the
    port's unsharded fused_linear_xent; the dw slabs, concatenated, equal
    both's dw."""
    ref, res = ranks
    inputs = ref["combine_inputs"]
    r_loss, r_dx, r_dw = ref["combine"][eps]
    x, w = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["w"])
    u_loss, vjp = torch.func.vjp(
        lambda a, b: fused_linear_xent(a, b, torch.from_numpy(
            inputs["labels"]), eps), x, w)
    u_dx, u_dw = vjp(torch.from_numpy(inputs["dy"]))
    dw = np.concatenate([res[r]["combine"][eps][2] for r in range(2)], 1)
    for want in ((r_loss, r_dx, r_dw), (u_loss.numpy(), u_dx.numpy(),
                                        u_dw.numpy())):
        for r in range(2):
            loss, dx, _ = res[r]["combine"][eps]
            np.testing.assert_allclose(loss, want[0], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(dx, want[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dw, want[2], rtol=1e-5, atol=1e-5)
    assert np.array_equal(res[0]["combine"][eps][0], res[1]["combine"][eps][0])
    assert np.array_equal(res[0]["combine"][eps][1], res[1]["combine"][eps][1])


# ---------------------------------------------------------------------------
# 4. the slice in small, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_vocab_parallel_training_matches_reference(ranks, model):
    """3 Adam steps on two ranks: losses within 1e-5 relative of the
    reference's mp-2 run, softmax_out.w and its moments (gathered) within
    1e-5 of their largest magnitude, each rank holding [H, V/2] slabs."""
    ref, res = ranks
    init, r_losses, r_final = ref[model]
    names = _vocab_names(init)
    assert len(names) == 3
    h, v = init[names[0]].shape
    for r in range(2):
        out = res[r][model]
        np.testing.assert_allclose(out["losses"], r_losses, rtol=1e-5)
        assert out["held"] == {n: (h, v // 2) for n in names}
        for n, got in zip(names, out["gathered"]):
            want = r_final[n]
            assert got.shape == want.shape == (h, v)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-5, (model, n, err)


@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_vocab_parallel_replicated_state_bit_equal_across_ranks(ranks, model):
    ref, res = ranks
    a, b = res[0][model], res[1][model]
    assert a["losses"] == b["losses"]
    assert len(a["replicated"]) == STEPS
    for step, (da, db) in enumerate(zip(a["replicated"], b["replicated"])):
        assert da and da == db, (model, step, [n for n in da
                                               if da[n] != db.get(n)][:5])


# ---------------------------------------------------------------------------
# 5. the port's own contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_spmd_comm_stats_count_each_steps_collectives(ranks, model):
    """Executor.spmd_comm_stats after each of a rank's steps: the step's
    collectives, read off the program.  fused_linear_xent's forward on a
    vocab slab all-reduces four [R, 1] parts (row max, exp-sum, gold
    logit, row sum), its grad op re-runs that forward and all-reduces dx
    [R, H]: 9 all-reduces a rank-step.  The last step also fetches the
    sharded softmax_out.w, gathered [H, V]."""
    _, res = ranks
    unique_name.switch()
    main, _, _, _ = _program(port_tfm, port_gpt2, model, None)
    block = main.global_block()
    xent = next(op for op in block.ops if op.type == "fused_linear_xent")
    x_shape = block.var(xent.inputs["X"][0]).shape
    w_shape = block.var(xent.inputs["W"][0]).shape
    rows = int(np.prod([BATCH if d < 0 else d for d in x_shape[:-1]]))
    hidden = x_shape[-1]
    step = {"all-reduce": {"count": 9,
                           "bytes": 4 * (8 * rows + rows * hidden)}}
    gather = {"count": 1, "bytes": 4 * w_shape[0] * w_shape[1]}
    for r in range(2):
        comm = res[r][model]["comm"]
        assert len(comm) == STEPS
        for stats in comm[:-1]:
            assert stats == {"per_op": step, "total_bytes":
                             step["all-reduce"]["bytes"]}, stats
        last = comm[-1]
        assert last["per_op"] == dict(step, **{"all-gather": gather}), last
        assert last["total_bytes"] == (step["all-reduce"]["bytes"]
                                       + gather["bytes"])


def test_fetch_of_sharded_weight_returns_the_full_value(ranks):
    _, res = ranks
    assert [res[r]["coord"] for r in range(2)] == [{"dp": 0, "mp": 0},
                                                   {"dp": 0, "mp": 1}]
    for r in range(2):
        out = res[r]["wmt"]
        assert out["fetched_w"].shape == out["gathered"][0].shape
        np.testing.assert_array_equal(out["fetched_w"], out["gathered"][0])


def test_odd_vocab_keeps_the_projection_whole(ranks):
    """Vocab 63 on mp 2: the divisibility guard replicates softmax_out.w
    (logged), the op runs fused_linear_xent (B4), never B12, in one
    step, and both ranks agree."""
    _, res = ranks
    a, b = res[0]["odd_vocab"], res[1]["odd_vocab"]
    for out in (a, b):
        # the forward op, and the grad op's re-run of the forward rule
        assert out["calls"] == {"fused": 2, "sharded": 0}
        assert out["held"] == (32, 63)
        assert any(n.startswith("softmax_out.w") and "63 !% mp=2" in why
                   for n, why in out["replicated_log"])
    assert a["loss"] == b["loss"]


@pytest.mark.parametrize("case", ["wmt", "gpt2", "dp2"])
def test_unported_layouts_raise(ranks, case):
    """The default transformer and gpt2 tables shard the trunk at mp 2,
    and a dp axis of 2 needs the gradient all-reduce: each raises
    NotImplementedError naming ROADMAP A7 (the tables name their first
    offending var) before any step runs."""
    _, res = ranks
    for r in range(2):
        msg = res[r]["unported"][case]
        assert msg is not None and "A7" in msg, (case, msg)
        if case != "dp2":
            assert "rule table splits" in msg, msg


@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_mp1_stamped_bit_identical_to_unstamped(model):
    """A {"dp": 1, "mp": 1} stamp changes nothing, with no process group:
    the guards shard nothing and the mesh-aware lowerings decline, so
    three Adam steps give bit-equal losses and state."""
    runs = []
    for mesh in (None, make_mesh({"dp": 1, "mp": 1})):
        unique_name.switch()
        main, start, loss, batch = _program(port_tfm, port_gpt2, model, mesh)
        assert (getattr(main, "_spmd", None) is None) == (mesh is None)
        start.random_seed = main.random_seed = 3
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            exe = ptt.Executor(ptt.CPUPlace())
            exe.run(start)
            losses = [exe.run(main, feed=batch, fetch_list=[loss])[0]
                      for _ in range(STEPS)]
            state = {n: scope.find_var(n).clone()
                     for n in scope.local_var_names()}
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    assert all(np.array_equal(a, b) for a, b in zip(la, lb))
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[n], sb[n]) for n in sa)


def test_gather_persistable_of_a_whole_var_is_the_scope_value():
    unique_name.switch()
    main, start, _, _ = _program(port_tfm, port_gpt2, "wmt",
                                 make_mesh({"dp": 1, "mp": 1}))
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        ptt.Executor(ptt.CPUPlace()).run(start)
        name = _vocab_names(scope.local_var_names())[0]
        assert gather_persistable(scope, main, name) is scope.find_var(name)
