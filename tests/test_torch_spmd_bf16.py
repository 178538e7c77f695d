"""The port's bf16 vocab-parallel training on the CPU, against the
reference: B12 (sharded_linear_xent) with bf16 x and w_local, per shard
and combined over two gloo ranks, and the tiny WMT and GPT-2 programs
built with use_bf16 on a {"dp": 1, "mp": 2} mesh whose rule table
vocab-shards softmax_out.w (the AMP pass's cast hands the op a bf16
mirror of the float32 master slab).

The reference runs under use_pallas on two virtual devices, its kernels
in interpret mode.  As in test_torch_spmd.py, all two-rank work runs in
ONE spawn (the `ranks` fixture) of module-level workers, and this module
imports no jax at top level (a spawned rank imports it).

Tolerances:
- the plain versions against the Pallas kernels on the same bf16
  operands: float32 outputs (lse, gold, sum) at rtol 1e-5 (atol 1e-5 of
  the largest magnitude: a row's logit sum may be near 0); bf16 outputs
  (dx, dw) within 1e-2 of the largest magnitude, as test_torch_amp.py,
  and equal to the reference's in at least 99% of their elements (1.0
  measured).  The last is C13's check: g rounded to bf16 before the
  products, as the reference's kernels round it; without the rounding
  0.63-0.70 of the elements are equal.
- the combine of two ranks under torch.func.vjp (eps 0.1, the WMT
  path's): the loss at rtol 1e-5, dx and dw within 1e-2 of the largest
  magnitude (measured: the loss within 7.8e-08, dx and dw equal).
- 3 Adam steps from the reference's startup arrays, test_torch_amp.py's
  bf16 training tolerances: losses at rtol 5e-3, each updated tensor's
  change from its start within a relative L2 distance of 0.6 of the
  reference's change (measured: losses within 8.7e-04 relative for WMT
  and equal for GPT-2; the largest change distance 0.23 for WMT, on a
  tensor whose gradient is near zero, and 0.020 for GPT-2).  The models
  are one layer deep, which keeps the reference's compiles short."""

import hashlib
import importlib
import json
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
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.models import transformer as port_tfm
from paddle_tpu_torch.parallel import (
    P,
    TrainPartitionRules,
    annotate_spmd,
    collective,
    make_mesh,
)
from paddle_tpu_torch.parallel.mesh import Mesh

slx = importlib.import_module("paddle_tpu_torch.kernels.sharded_linear_xent")

SRC = TRG = 8
BATCH = 4
STEPS = 3
WMT_LR, WMT_WARMUP = 0.005, 2  # test_torch_amp.py's bf16 WMT schedule
GPT2_LR = 3e-3
VOCAB_RULE = [(r"softmax_out\.w", P(None, "mp"))]
# the per-shard cases: R rows (ragged against the reference's row
# block), H hidden, VL the slab's columns, VT the whole vocab
R1, H1, VL1, VT1 = 40, 32, 48, 96
# combine inputs: R rows, H hidden, V vocab over 2 shards
CR, CH, CV = 20, 16, 48


def _bf16(a):
    """A float32 numpy array rounded to bf16, as a torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _wmt_hp(base):
    return type("TinyWMT", (base,), dict(
        src_vocab_size=64, trg_vocab_size=64, max_length=16, d_model=32,
        d_inner_hid=64, n_head=4, n_layer=1, dropout=0.0))


def _gpt2_hp(base):
    return type("TinyGPT2", (base,), dict(
        vocab_size=64, n_ctx=16, d_model=32, n_layer=1, n_head=4,
        d_inner=64, dropout=0.0, tie_embeddings=False))


def _program(pkg_tfm, pkg_gpt2, model, mesh):
    """(main, startup, loss var, batch) of `model` with use_bf16, built by
    one package."""
    if model == "wmt":
        hp = _wmt_hp(pkg_tfm.ModelHyperParams)
        main, start, _, fetch = pkg_tfm.wmt_transformer_program(
            hp, src_len=SRC, trg_len=TRG, learning_rate=WMT_LR,
            warmup_steps=WMT_WARMUP, use_bf16=True, mesh=mesh)
        return main, start, fetch[0], pkg_tfm.make_fake_batch(
            BATCH, SRC, TRG, hp, seed=0)
    hp = _gpt2_hp(pkg_gpt2.GPT2Config)
    main, start, _, fetch = pkg_gpt2.gpt2_lm_program(
        hp, seq_len=SRC, lr=GPT2_LR, use_bf16=True, mesh=mesh)
    return main, start, fetch[0], pkg_gpt2.make_fake_lm_batch(
        BATCH, SRC, hp, seed=0)


def _vocab_names(names):
    """softmax_out.w and its two Adam moments: the sharded persistables."""
    return sorted(n for n in names if n.startswith("softmax_out.w")
                  and "pow" not in n)


# ---------------------------------------------------------------------------
# rank workers (module level: a spawned rank imports this module)
# ---------------------------------------------------------------------------
def _digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _combine_rank(rank, inputs):
    """sharded_linear_xent on this rank's bf16 slab under torch.func.vjp:
    (loss, dx, dw slab) as float32 numpy, at eps 0.1."""
    x, w = _bf16(inputs["x"]), _bf16(inputs["w"])
    labels, dy = (torch.from_numpy(inputs[k]) for k in ("labels", "dy"))
    vl = CV // 2
    wl = w[:, rank * vl:(rank + 1) * vl].contiguous()
    group = make_mesh({"dp": 1, "mp": 2}).group("mp")
    loss, vjp = torch.func.vjp(
        lambda a, b: slx.sharded_linear_xent(a, b, labels, 0.1, group,
                                             rank * vl, CV), x, wl)
    dx, dw = vjp(dy)
    assert (loss.dtype, dx.dtype, dw.dtype) == (
        torch.float32, torch.bfloat16, torch.bfloat16)
    return tuple(t.float().numpy() for t in (loss, dx, dw))


def _train_rank(model, mesh, init):
    """3 Adam steps of `model` in bf16 from the carried weights under the
    vocab-only table: losses, the held slabs' shapes and dtypes, a digest
    of every replicated persistable after every step, and every
    persistable at the end (the slabs gathered)."""
    unique_name.switch()
    main, start, loss, batch = _program(port_tfm, port_gpt2, model, mesh)
    annotate_spmd(main, mesh, TrainPartitionRules(VOCAB_RULE))
    scope = ptt.Scope()
    out = {"losses": [], "replicated": []}
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        exe = ptt.Executor(ptt.CPUPlace())
        names = _vocab_names(init)
        for _ in range(STEPS):
            got = exe.run(main, feed=batch, fetch_list=[loss])
            out["losses"].append(float(np.asarray(got[0]).sum()))
            out["replicated"].append({
                n: _digest(scope.find_var(n)) for n in sorted(init)
                if n not in names})
        out["held"] = {n: (tuple(scope.find_var(n).shape),
                           str(scope.find_var(n).dtype)) for n in names}
        out["final"] = {n: gather_persistable(scope, main, n).numpy()
                        for n in sorted(init)}
        out["comm"] = exe.spmd_comm_stats(main)
    return out


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
        for model in ("wmt", "gpt2"):
            out[model] = _train_rank(model, mesh, job["init"][model])
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
def _ref_mesh():
    import jax

    from paddle_tpu.parallel import make_mesh as ref_make_mesh

    return ref_make_mesh({"dp": 1, "mp": 2}, devices=jax.devices()[:2])


def _ref_vocab_parallel(model):
    """The reference's bf16 run of `model` with use_pallas on a {"dp": 1,
    "mp": 2} mesh of 2 virtual devices, re-stamped with the vocab-only
    table: (startup arrays, losses, final arrays)."""
    import paddle_tpu as fluid
    from paddle_tpu import flags
    from paddle_tpu.models import gpt2 as ref_gpt2
    from paddle_tpu.models import transformer as ref_tfm
    from paddle_tpu.parallel.partition_rules import (
        P as RP,
        TrainPartitionRules as RTrain,
        annotate_spmd as ref_annotate,
    )

    old = {k: flags.get_flag(k) for k in ("use_pallas", "kernel_autotune")}
    flags.set_flags({"use_pallas": True, "kernel_autotune": False})
    try:
        mesh = _ref_mesh()
        main, start, loss, batch = _program(ref_tfm, ref_gpt2, model, mesh)
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
                for _ in range(STEPS)]
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
    """pk.sharded_linear_xent inside shard_map on 2 virtual devices, on
    bf16 x and w at eps 0.1, under jax.vjp: (loss, dx, dw) as float32, dw
    the full [H, V]."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.ops import pallas_kernels as pk
    from paddle_tpu.parallel import make_mesh as ref_make_mesh
    from paddle_tpu.parallel.mesh import shard_map

    mesh = ref_make_mesh({"mp": 2}, devices=jax.devices()[:2])
    x = jnp.asarray(inputs["x"]).astype(jnp.bfloat16)
    w = jnp.asarray(inputs["w"]).astype(jnp.bfloat16)
    labels = jnp.asarray(inputs["labels"]).astype(jnp.int32)
    br, bv = pk._lxent_default_blocks(CR, CH, CV // 2)

    def body(xl, wl, ll):
        return pk.sharded_linear_xent(xl, wl, ll, 0.1, "mp", CV, br, bv)

    f = shard_map(body, mesh=mesh,
                  in_specs=(JP(None, None), JP(None, "mp"), JP(None)),
                  out_specs=JP(None, None), check_rep=False)
    loss, vjp = jax.vjp(lambda a, b: f(a, b, labels), x, w)
    dx, dw = vjp(jnp.asarray(inputs["dy"]))
    return tuple(np.asarray(v.astype(jnp.float32)) for v in (loss, dx, dw))


@pytest.fixture(scope="module")
def ranks():
    """The reference's runs, then ONE spawn of two gloo CPU ranks that
    run every two-rank part; returns (reference results, [rank 0,
    rank 1] results)."""
    ref = {"combine_inputs": _combine_inputs()}
    ref["combine"] = _ref_combine(ref["combine_inputs"])
    for model in ("wmt", "gpt2"):
        ref[model] = _ref_vocab_parallel(model)
    job = {"combine": ref["combine_inputs"],
           "init": {m: ref[m][0] for m in ("wmt", "gpt2")}}
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
# 1. B12's plain versions in bf16, against the Pallas kernels
# ---------------------------------------------------------------------------
def _shard_case(shard, seed=5):
    """bf16-valued x and w_local (as float32 numpy), local labels (in
    this shard, in the other, -1 and the whole vocab), the global row
    validity, a global lse and dy."""
    rng = np.random.RandomState(seed + shard)
    x = _bf16(rng.randn(R1, H1).astype("float32")).float().numpy()
    w = _bf16((rng.randn(H1, VL1) * H1 ** -0.5).astype("float32")).float() \
        .numpy()
    labels = rng.randint(0, VT1, R1).astype("int64")
    labels[:4] = [shard * VL1 + 2, (1 - shard) * VL1, -1, VT1]
    local = labels - shard * VL1
    valid = ((labels >= 0) & (labels < VT1)).astype("float32")
    dy = rng.rand(R1).astype("float32")
    return x, w, local, valid, dy


def _ref_bf16(x, w):
    import jax.numpy as jnp

    return (jnp.asarray(x).astype(jnp.bfloat16),
            jnp.asarray(w).astype(jnp.bfloat16))


@pytest.mark.parametrize("shard", [0, 1])
def test_parts_plain_bf16_matches_pallas(shard):
    """(lse, gold, sum) of a bf16 slab: float32 [R, 1] from the bf16
    products, as _lxent_parts forms them."""
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_kernels as pk

    x, w, local, _, _ = _shard_case(shard)
    xb, wb = _ref_bf16(x, w)
    br, bv = pk._lxent_default_blocks(R1, H1, VL1)
    want = pk._lxent_parts(xb, wb, jnp.asarray(local.astype("int32")), br,
                           bv)
    got = slx.linear_xent_parts_plain(_bf16(x), _bf16(w),
                                      torch.from_numpy(local))
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (R1, 1)
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("shard", [0, 1])
def test_grad_sharded_plain_bf16_matches_pallas(eps, shard):
    """C13: dx and dw of a bf16 slab with g rounded to bf16 before each
    product, as _lxent_dx_kernel_sharded / _lxent_dw_kernel_sharded
    round it (g.astype(x_ref.dtype)): bf16 outputs within 1e-2 of the
    largest magnitude and equal to the reference's in >= 99% of the
    elements (an unrounded g leaves 0.63-0.70 equal)."""
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_kernels as pk

    x, w, local, valid, dy = _shard_case(shard)
    xb, wb = _ref_bf16(x, w)
    br, bv = pk._lxent_default_blocks(R1, H1, VL1)
    lse = (np.asarray(pk._lxent_parts(
        xb, wb, jnp.asarray(local.astype("int32")), br, bv)[0])
        + np.float32(np.log(2.0))).astype("float32")  # a global lse
    want = pk._lxent_bwd_sharded(
        xb, wb, jnp.asarray(local.astype("int32")), jnp.asarray(valid),
        jnp.asarray(lse), jnp.asarray(dy), eps, VT1, br, bv)
    got = slx.linear_xent_grad_sharded_plain(
        _bf16(x), _bf16(w), torch.from_numpy(local), torch.from_numpy(valid),
        torch.from_numpy(lse), torch.from_numpy(dy)[:, None], eps, VT1)
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        assert np.abs(g - r).max() <= 1e-2 * np.abs(r).max()
        assert (g == r).mean() >= 0.99, (g == r).mean()


def test_grad_sharded_plain_float32_unchanged_by_the_rounding():
    """In float32 the rounding of g is the identity: the plain backward
    equals, bit for bit, the same arithmetic with no rounding step."""
    x, w, local, valid, dy = (torch.from_numpy(a) for a in _shard_case(1))
    lse = torch.logsumexp(x @ w, -1, keepdim=True) + np.log(2.0)
    for eps in (0.0, 0.1):
        got = slx.linear_xent_grad_sharded_plain(x, w, local, valid, lse,
                                                 dy[:, None], eps, VT1)
        p = torch.exp(x @ w - lse)
        onehot = (torch.arange(VL1)[None, :] == local[:, None]).float()
        g = valid[:, None] * (1.0 - eps) * (p - onehot)
        if eps:
            g = g + eps * (p - 1.0 / VT1)
        g = g * dy[:, None]
        assert torch.equal(got[0], g @ w.t())
        assert torch.equal(got[1], x.t() @ g)


def test_bf16_wrappers_launch_their_own_entry_points(monkeypatch):
    """bf16 x and w_local reach the three bf16 C entry points with R, H,
    V and the split count (parts) or vocab_total and eps (dx, dw), each
    counted under its bf16 name; the float32 counters do not move.  lse,
    gold and sum are float32 [R, 1]; dx and dw bf16."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: calls.append((name, args)))
    x, w, local, valid, dy = _shard_case(0)
    xb, wb, lbl = _bf16(x), _bf16(w), torch.from_numpy(local)
    lse = torch.zeros(R1, 1)
    counters = (slx.linear_xent_parts, slx.linear_xent_dx_sharded,
                slx.linear_xent_dw_sharded, slx.linear_xent_parts_bf16,
                slx.linear_xent_dx_sharded_bf16,
                slx.linear_xent_dw_sharded_bf16)
    before = {f.__name__: f.launches for f in counters}
    parts = slx.linear_xent_parts(xb, wb, lbl)
    args = (xb, wb, lbl, torch.from_numpy(valid), lse,
            torch.from_numpy(dy)[:, None], 0.1, VT1)
    dx = slx.linear_xent_dx_sharded(*args)
    dw = slx.linear_xent_dw_sharded(*args)
    assert [c[0] for c in calls] == [
        "ptt_linear_xent_parts_bf16", "ptt_linear_xent_dx_sharded_bf16",
        "ptt_linear_xent_dw_sharded_bf16"]
    assert list(calls[0][1][-4:]) == [R1, H1, VL1,
                                      slx.fwd_splits(R1, VL1)]
    for _, a in calls[1:]:
        assert list(a[-5:-1]) == [R1, H1, VL1, VT1]
        assert a[-1] == pytest.approx(0.1)
    assert all(t.dtype == torch.float32 and tuple(t.shape) == (R1, 1)
               for t in parts)
    assert dx.dtype == dw.dtype == torch.bfloat16
    after = {f.__name__: f.launches for f in counters}
    assert {k: after[k] - before[k] for k in after} == {
        "linear_xent_parts": 0, "linear_xent_dx_sharded": 0,
        "linear_xent_dw_sharded": 0, "linear_xent_parts_bf16": 1,
        "linear_xent_dx_sharded_bf16": 1, "linear_xent_dw_sharded_bf16": 1}
    # a bf16 row validity is refused before any launch
    with pytest.raises(build.KernelTypeError, match="operand 2"):
        slx.linear_xent_dx_sharded(xb, wb, lbl, torch.from_numpy(valid).to(
            torch.bfloat16), lse, torch.from_numpy(dy)[:, None], 0.1, VT1)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# 2. the programs, op for op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_bf16_vocab_parallel_programs_match_reference(model):
    """The use_bf16 programs built on the mesh equal the reference's op
    for op through to_json (stamping leaves the IR as it is); the vocab
    projection's W is the bf16 mirror a cast writes from the float32
    master, and the executor holds the master as the vocab slab."""
    from paddle_tpu import unique_name as ref_unique_name
    from paddle_tpu.models import gpt2 as ref_gpt2
    from paddle_tpu.models import transformer as ref_tfm

    from paddle_tpu_torch.executor import _vocab_projections

    with ref_unique_name.guard():
        ref = _program(ref_tfm, ref_gpt2, model, _ref_mesh())[0]
    with unique_name.guard():
        port = _program(port_tfm, port_gpt2, model,
                        Mesh(("dp", "mp"), (1, 2), (0, 1), {}))[0]
    r, p = json.loads(ref.to_json()), json.loads(port.to_json())
    r_ops, p_ops = r["blocks"][0]["ops"], p["blocks"][0]["ops"]
    assert len(p_ops) == len(r_ops)
    for i, (a, b) in enumerate(zip(r_ops, p_ops)):
        assert b == a, "op %d differs:\nref  %s\nport %s" % (i, a, b)
    block = port.global_block()
    xent = [op for op in block.ops if op.type == "fused_linear_xent"]
    assert len(xent) == 1
    mirror = xent[0].inputs["W"][0]
    assert mirror == "softmax_out.w_0@BF16"
    assert block.var(mirror).dtype == "bfloat16"
    assert not block.var(mirror).persistable
    assert _vocab_projections(block) == {"softmax_out.w_0"}
    rules = TrainPartitionRules(VOCAB_RULE)
    shape = tuple(block.var(mirror).shape)
    assert tuple(rules.spec_for(mirror, shape)) == (None, "mp")
    assert block.var("softmax_out.w_0").dtype == "float32"


# ---------------------------------------------------------------------------
# 3. two ranks
# ---------------------------------------------------------------------------
def test_bf16_combine_matches_reference_shard_map(ranks):
    """Every rank's loss and summed dx, and each rank's dw slab, against
    pk.sharded_linear_xent inside shard_map under jax.vjp on the same
    bf16 operands."""
    ref, results = ranks
    r_loss, r_dx, r_dw = ref["combine"]
    vl = CV // 2
    for rank, res in enumerate(results):
        loss, dx, dw = res["combine"]
        np.testing.assert_allclose(loss, r_loss, rtol=1e-5, atol=1e-6)
        assert np.abs(dx - r_dx).max() <= 1e-2 * np.abs(r_dx).max()
        want = r_dw[:, rank * vl:(rank + 1) * vl]
        assert np.abs(dw - want).max() <= 1e-2 * np.abs(want).max()


def _held(r_losses, losses, init, r_final, final):
    """test_torch_amp.py's bf16 tolerances: losses at rtol 5e-3, every
    float32 persistable's change from `init` within a relative L2
    distance of 0.6 of the reference's change."""
    np.testing.assert_allclose(losses, r_losses, rtol=5e-3)
    assert len(set(losses)) == len(losses)  # the parameters moved
    moved = 0
    for name, want in r_final.items():
        got = final[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if want.dtype != np.float32:
            continue
        d_want = want.astype(np.float64) - init[name]
        d_got = got.astype(np.float64) - init[name]
        norm = np.linalg.norm(d_want)
        if norm == 0:
            assert np.linalg.norm(d_got) == 0, name
            continue
        assert np.linalg.norm(d_got - d_want) <= 0.6 * norm, (
            name, np.linalg.norm(d_got - d_want) / norm)
        moved += 1
    assert moved > len(r_final) // 2


@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_bf16_vocab_parallel_training_matches_reference(ranks, model):
    """3 Adam steps of the bf16 program on two ranks against the
    reference's on two virtual devices: the losses, and every
    persistable (the vocab slabs gathered) at the end."""
    ref, results = ranks
    init, r_losses, r_final = ref[model]
    for res in results:
        _held(r_losses, res[model]["losses"], init, r_final,
              res[model]["final"])


@pytest.mark.parametrize("model", ["wmt", "gpt2"])
def test_bf16_master_slabs_and_replicated_state(ranks, model):
    """Each rank holds softmax_out.w and its Adam moments as float32
    [H, V/2] slabs, every replicated persistable is bit-equal across the
    ranks after every step, and the step's collectives are float32 but
    dx's, which is summed in bf16: 8 of [R, 1] float32 and one [R, H]
    bf16 in the forward and its grad re-run."""
    _, results = ranks
    for res in results:
        assert res[model]["held"] == {
            n: ((32, 32), "torch.float32") for n in res[model]["held"]}
        assert len(res[model]["held"]) == 3
    a, b = results[0][model], results[1][model]
    assert a["losses"] == b["losses"]
    for step in range(STEPS):
        assert a["replicated"][step] == b["replicated"][step], step
    rows = BATCH * TRG
    assert a["comm"]["per_op"] == {"all-reduce": {
        "count": 9, "bytes": 4 * 8 * rows + 2 * rows * 32}}
