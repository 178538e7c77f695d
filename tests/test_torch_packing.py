"""The port's packed causal-LM slice on the CPU, against the JAX package:
``reader.pack_sequences``; the compare ops and ``cast`` (lowerings and
the float cast's gradient); ``examples/packed_training_torch.py``'s
program against ``examples/packed_training.py``'s, op for op, and five
Adam steps of it from the reference's startup state; flash attention's
segment-id and sliding-window forms (the plain versions and the
autograd wrappers) against the Pallas kernels in interpret mode,
forward, lse and ``jax.vjp``; and the wrappers' kernel path for those
forms (their launch operands; on a card, the kernels themselves).

Tolerances: rtol = atol = 1e-5 for op outputs and attention (float32,
the two sides sum in different orders); losses rtol 1e-5; parameters
and Adam moments within 1e-4 of each tensor's largest magnitude, as in
test_torch_gpt2_training.py (Adam divides by sqrt(moment2) + eps, so a
near-zero gradient turns float32 summation-order noise into an update
of up to lr)."""

import functools
import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import LowerCtx as RefCtx
from paddle_tpu.core.registry import lower_grad_op as ref_grad
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.reader import pack_sequences as ref_pack_sequences
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.core.registry import LowerCtx, lower_grad_op
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.kernels import (
    build,
    flash_attention,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_grad_plain,
    flash_attention_piece,
    flash_attention_piece_grad_plain,
    flash_attention_piece_plain,
    flash_attention_plain,
)
from paddle_tpu_torch.reader import pack_sequences

from test_torch_ops import _grad_attrs, _run_both
from test_torch_program import _assert_same_program

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG_INF = -1e30


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


@functools.lru_cache(maxsize=None)
def _example(name):
    """An example module loaded by its path (examples/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "example_" + name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# pack_sequences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq_len,n,pad_id,dtype,seed", [
    (16, 24, 0, "int64", 0),
    (10, 6, 0, "int64", 1),
    (64, 40, -1, "int32", 2),
    (7, 1, 3, "int64", 3),     # one sequence
    (8, 12, 0, "int64", 4),    # many equal lengths: the sort's ties
])
def test_pack_sequences_matches_reference(seq_len, n, pad_id, dtype, seed):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(1, 100, (rng.randint(1, seq_len + 1),))
            for _ in range(n)]
    if seed == 4:
        seqs = [rng.randint(1, 100, (3,)) for _ in range(n)]
    want = ref_pack_sequences(seqs, seq_len, pad_id, dtype)
    got = pack_sequences(seqs, seq_len, pad_id, dtype)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    tokens, seg, pos = got
    assert (seg > 0).sum() == sum(s.size for s in seqs)
    assert (tokens[seg == 0] == pad_id).all() and (pos[seg == 0] == 0).all()


@pytest.mark.parametrize("seqs", [[np.arange(11)], [np.arange(3), []]])
def test_pack_sequences_raises_as_reference(seqs):
    with pytest.raises(ValueError) as want:
        ref_pack_sequences(seqs, 10)
    with pytest.raises(ValueError) as got:
        pack_sequences(seqs, 10)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the compare ops and cast
# ---------------------------------------------------------------------------
_R = np.random.RandomState(7)
_COMPARE = ("less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal")


@pytest.mark.parametrize("op_type", _COMPARE)
@pytest.mark.parametrize("form", ["same_shape", "axis", "scalar", "int"])
def test_compare_ops_match_reference(op_type, form):
    """Bool Out equal to the reference's lowering: same shapes, Y aligned
    at `axis` (bcast_y), a [1] Y (the materialized scalar of `seg > 0`)
    and int operands with ties."""
    x = np.round(_R.randn(2, 3, 4), 1).astype("float32")
    if form == "same_shape":
        y, axis = np.where(_R.rand(2, 3, 4) < 0.3, x,
                           _R.randn(2, 3, 4)).astype("float32"), -1
    elif form == "axis":
        y, axis = np.round(_R.randn(3), 1).astype("float32"), 1
    elif form == "scalar":
        y, axis = np.zeros((1,), "float32"), -1
    else:
        x = _R.randint(0, 3, (2, 5, 1)).astype("int32")
        y, axis = np.zeros((1,), "int32"), -1
    ref, out = _run_both(op_type, {"X": [x], "Y": [y]}, {"axis": axis})
    assert out["Out"][0].dtype == np.bool_
    np.testing.assert_array_equal(out["Out"][0], ref["Out"][0])


@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("bool", "float32"), ("int32", "float32"), ("float32", "int32"),
    ("float32", "float32"), ("int64", "int32")])
def test_cast_matches_reference(in_dtype, out_dtype):
    x = (_R.randn(3, 4) * 3).astype(in_dtype)
    if in_dtype == "bool":
        x = _R.rand(3, 4) < 0.5
    ref, out = _run_both("cast", {"X": [x]},
                         {"in_dtype": in_dtype, "out_dtype": out_dtype})
    assert out["Out"][0].dtype == np.dtype(out_dtype)
    np.testing.assert_array_equal(out["Out"][0], ref["Out"][0])


@pytest.mark.parametrize("in_dtype", ["float32", "bool", "int32"])
def test_cast_grad_matches_reference(in_dtype):
    """A float cast's gradient through the generic vjp; a bool or int X
    takes none, as in the reference."""
    x = _R.randn(3, 4).astype("float32")
    if in_dtype != "float32":
        x = (x > 0).astype(in_dtype)
    attrs = {"in_dtype": in_dtype, "out_dtype": "float32"}
    gins = {"X": [x], "Out@GRAD": [_R.randn(3, 4).astype("float32")]}
    gattrs = _grad_attrs("cast", attrs, {"X": [x]}, ["Out"])
    ref = ref_grad(RefCtx(), None,
                   {s: [jnp.asarray(a) for a in v] for s, v in gins.items()},
                   gattrs)
    out = lower_grad_op(LowerCtx(device="cpu"),
                        {s: [torch.tensor(a) for a in v]
                         for s, v in gins.items()}, gattrs)
    assert set(out) == set(ref) == ({"X@GRAD"} if in_dtype == "float32"
                                    else set())
    for slot in ref:
        np.testing.assert_allclose(out[slot][0].numpy(),
                                   np.asarray(ref[slot][0]), **TOL)


@pytest.mark.parametrize("case", [
    ("segments", {"SegmentIds": [np.array([[1, 1, 1, 2, 2, 0],
                                           [1, 2, 2, 2, 3, 3]], "int32")]},
     {"causal": True, "window": 0}),
    ("segments_bidirectional", {"SegmentIds": [np.array(
        [[1, 1, 1, 2, 2, 0], [1, 2, 2, 2, 3, 3]], "int32")]},
     {"causal": False, "window": 0}),
    ("window", {}, {"causal": True, "window": 2}),
    ("window_segments", {"SegmentIds": [np.array(
        [[1, 1, 1, 1, 2, 2], [1, 1, 2, 2, 2, 2]], "int32")]},
     {"causal": True, "window": 3}),
], ids=lambda c: c[0])
def test_fused_attention_packed_forms_and_grads_match_reference(case):
    """The fused_attention op's segment and window forms, forward and
    <op>_grad (torch.func.vjp through the flash_attention autograd
    wrapper) against the reference's lowerings (jax.vjp)."""
    _, extra, attrs = case
    ins = dict({s: [_R.randn(2, 2, 6, 8).astype("float32")]
                for s in ("Q", "K", "V")}, **extra)
    attrs = dict(attrs, scale=None)
    ref, out = _run_both("fused_attention", ins, attrs)
    np.testing.assert_allclose(out["Out"][0], ref["Out"][0], **TOL)
    gins = dict(ins, **{"Out@GRAD": [_R.randn(2, 2, 6, 8).astype("float32")]})
    gattrs = _grad_attrs("fused_attention", attrs, ins, ["Out"])
    r = ref_grad(RefCtx(), None,
                 {s: [jnp.asarray(a) for a in v] for s, v in gins.items()},
                 gattrs)
    g = lower_grad_op(LowerCtx(device="cpu"),
                      {s: [torch.tensor(a) for a in v]
                       for s, v in gins.items()}, gattrs)
    assert set(g) == set(r) == {"Q@GRAD", "K@GRAD", "V@GRAD"}
    for slot in r:
        np.testing.assert_allclose(g[slot][0].numpy(), np.asarray(r[slot][0]),
                                   **TOL)


# ---------------------------------------------------------------------------
# the packed-training program
# ---------------------------------------------------------------------------
class _WindowedLayers:
    """The reference package's layers with a window on fused_attention:
    the reference example's program with `window`, built by its own
    build()."""

    def __init__(self, window):
        self.window = window

    def __getattr__(self, name):
        return getattr(fluid.layers, name)

    def fused_attention(self, *args, **kw):
        return fluid.layers.fused_attention(*args, window=self.window, **kw)


def _ref_build(monkeypatch, n_rows, vocab, seq_len, d_model, heads, window):
    ref = _example("packed_training")
    for name, val in (("VOCAB", vocab), ("L", seq_len), ("D", d_model),
                      ("HEADS", heads)):
        monkeypatch.setattr(ref, name, val)
    if window:
        monkeypatch.setattr(ref, "layers", _WindowedLayers(window))
    with fluid.unique_name.guard():
        return ref.build(n_rows)


# the example's own constants, and a head-dim-64 config (the kernels'
# width) with and without a window narrower than its rows
_CONFIGS = {"example": (40, 16, 32, 4, 0),
            "dh64": (61, 64, 128, 2, 0),
            "dh64_window48": (61, 64, 128, 2, 48)}


def _feed(vocab, seq_len, seed):
    """Ragged successor sequences packed as the reference example feeds
    them; the port example's make_feed must build the same arrays."""
    rng = np.random.RandomState(seed)
    seqs = [(rng.randint(0, vocab) + np.arange(
        rng.randint(3, min(seq_len, 40) + 1))) % vocab for _ in range(24)]
    feed, seg = _example("packed_training_torch").make_feed(seqs, seq_len)
    tokens, r_seg, pos = ref_pack_sequences(seqs, seq_len)
    labels = np.roll(tokens, -1, axis=1)
    valid = (r_seg > 0) & (r_seg == np.roll(r_seg, -1, axis=1))
    want = {"tokens": tokens, "seg": np.where(valid, r_seg, 0).astype("int32"),
            "pos": pos.astype("int64"), "labels": labels}
    assert sorted(feed) == sorted(want)
    for k in want:
        assert feed[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(feed[k], want[k])
    np.testing.assert_array_equal(seg, r_seg)
    return feed


@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_packed_program_matches_reference(monkeypatch, config):
    """build() emits the reference example's program op for op (types,
    slots, var names, attrs, shapes and dtypes), forward, grads and
    Adam, and its startup program; window > 0 sets the one attention's
    window."""
    vocab, seq_len, d_model, heads, window = _CONFIGS[config]
    r_main, r_start, r_loss = _ref_build(monkeypatch, 5, vocab, seq_len,
                                         d_model, heads, window)
    p_main, p_start, p_loss = _example("packed_training_torch").build(
        5, vocab, seq_len, d_model, heads, window)
    _assert_same_program(r_start, p_start)
    _assert_same_program(r_main, p_main)
    assert p_loss.name == r_loss.name
    types = [o.type for o in p_main.global_block().ops]
    attn = [o for o in p_main.global_block().ops if o.type == "fused_attention"]
    assert len(attn) == 1 and attn[0].attrs["window"] == window
    assert attn[0].attrs["causal"] and "SegmentIds" in attn[0].inputs
    assert types.count("fused_attention_grad") == 1
    assert types.count("greater_than") == types.count("cast") == 1
    assert types.count("adam") == 5


@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_packed_training_matches_reference_over_adam_steps(monkeypatch,
                                                           config):
    """Five Adam steps from the reference's startup arrays, carried over
    as numpy: losses at rtol 1e-5, parameters and moments within 1e-4 of
    each tensor's largest magnitude."""
    vocab, seq_len, d_model, heads, window = _CONFIGS[config]
    feed = _feed(vocab, seq_len, seed=len(config))
    n_rows = feed["tokens"].shape[0]
    r_main, r_start, r_loss = _ref_build(monkeypatch, n_rows, vocab, seq_len,
                                         d_model, heads, window)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(r_start)
        names = [n for n, v in r_start.global_block().vars.items()
                 if v.persistable]
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        r_losses = [float(np.asarray(exe.run(r_main, feed=feed,
                                             fetch_list=[r_loss])[0]).sum())
                    for _ in range(5)]
        r_final = {n: np.asarray(scope.find_var(n)) for n in names}

    main, _, loss = _example("packed_training_torch").build(
        n_rows, vocab, seq_len, d_model, heads, window)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        params_from_numpy(init, scope, ptt.CPUPlace())
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0].sum())
                  for _ in range(5)]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    assert len(set(losses)) == 5 and abs(losses[0] - np.log(vocab)) < 1.0
    moved = 0
    for name, want in r_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name
        moved += not np.array_equal(want, init[name])
    assert moved > len(r_final) // 2


def test_packed_example_main_learns_the_successor_rule():
    """The port example's main() on the CPU place it is handed: 24
    seeded ragged sequences, 60 Adam steps, the masked loss below half
    its first value (it asserts so itself)."""
    example = _example("packed_training_torch")
    losses = example.main(place=ptt.CPUPlace())
    assert len(losses) == 60 and losses[-1] < 0.5 * losses[0]


def test_packed_step_launches_the_flash_wrappers_with_its_forms(monkeypatch):
    """One step of the example's program (head dim 64, window 5) with the
    kernel path forced on and each launch replayed by the plain versions:
    fused_attention's forward launches B3's forward with the window and
    the [B*H, T] int32 segment ids, its grad op B3's forward, dq and
    dk/dv with the same operands, nothing else launches, and the loss and
    updated weights equal the plain path's bit for bit."""
    feed = _feed(40, 16, seed=5)
    n_rows = feed["tokens"].shape[0]
    main, start, loss = _example("packed_training_torch").build(
        n_rows, d_model=128, heads=2, window=5)
    runs = []
    for kernel_path in (False, True):
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            exe = ptt.Executor(ptt.CPUPlace())
            if not kernel_path:
                exe.run(start)
                init = {n: scope.find_var(n).clone()
                        for n in scope.local_var_names()}
            else:
                for n, w in init.items():
                    scope.set(n, w.clone())
                launched = _launch_fills_from_plain(monkeypatch)
            out = exe.run(main, feed=feed, fetch_list=[loss])[0]
            runs.append((out, {n: scope.find_var(n).clone() for n in init}))
    names = [n for n, _ in launched]
    assert names == ["ptt_flash_attention_fwd"] * 2 + [
        "ptt_flash_attention_dq", "ptt_flash_attention_dkv"]
    want_seg = np.repeat(feed["seg"], 2, axis=0)
    for _, args in launched:
        assert args[-2] == 5
        assert args[-1].dtype == torch.int32
        np.testing.assert_array_equal(args[-1].numpy(), want_seg)
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    for n, w in runs[0][1].items():
        assert torch.equal(runs[1][1][n], w), n


# ---------------------------------------------------------------------------
# flash attention's segment and window forms against the Pallas kernels
# ---------------------------------------------------------------------------
def _packed_ids(rng, bh, t, pad):
    """[BH, T] int32 ids: segments of random lengths, 1, 2, ..., and a
    padding tail of segment 0."""
    seg = np.zeros((bh, t), np.int32)
    for r in range(bh):
        off, sid = 0, 1
        while off < t - pad:
            n = min(rng.randint(1, t // 3), t - pad - off)
            seg[r, off:off + n] = sid
            off, sid = off + n, sid + 1
    return seg


@pytest.mark.parametrize("bh,t,block,causal,window,with_seg,with_bias", [
    (2, 256, 128, True, 0, True, False),    # packed, causal: blocks skip none
    (3, 128, 64, False, 0, True, True),     # bidirectional packing, key bias
    (2, 64, 32, True, 1, False, False),     # each query sees itself only
    (3, 256, 64, True, 48, False, False),
    (2, 256, 128, True, 200, False, True),  # not a multiple of the block
    (4, 128, 32, True, 48, True, False),    # window and segments together
], ids=["seg_causal", "seg_bidirectional_bias", "window1", "window48",
        "window200_bias", "window48_seg"])
def test_flash_segment_and_window_forms_match_reference_kernel(
        bh, t, block, causal, window, with_seg, with_bias):
    """flash_attention_plain's (o, lse) against the reference's _flash_fwd
    with `window` and `seg`, and the autograd wrapper's (dq, dk, dv[,
    dkbias]) under torch.func.vjp and flash_attention_grad_plain's
    against the reference's flash_attention under jax.vjp, Pallas
    interpret mode.  rtol = atol = 1e-5."""
    rng = np.random.RandomState(t + window + bh)
    d, scale = 16, 0.25
    q, k, v, do = (rng.randn(bh, t, d).astype("float32") for _ in range(4))
    seg = _packed_ids(rng, bh, t, pad=t // 8) if with_seg else None
    kb = None
    if with_bias:
        kb = rng.randn(bh, t).astype("float32")
        kb[:, -3:] = -1e9
    jseg = None if seg is None else jnp.asarray(seg)
    jkb = None if kb is None else jnp.asarray(kb)
    r_o, r_lse = pk._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jkb if kb is not None else jnp.zeros((bh, t), jnp.float32),
        causal, scale, block, block, window, seg=jseg)
    prim = [jnp.asarray(a) for a in (q, k, v)] + ([jkb] if kb is not None
                                                  else [])
    r_out, vjp = jax.vjp(
        lambda *a: pk.flash_attention(*a[:3], a[3] if len(a) > 3 else None,
                                      causal, scale, block, block, window,
                                      jseg), *prim)
    r_grads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(np.asarray(r_out), np.asarray(r_o), **TOL)

    tseg = None if seg is None else _t(seg).long()
    tkb = None if kb is None else _t(kb)
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), tkb, causal, scale,
                                   None, window, tseg)
    np.testing.assert_allclose(o.numpy(), np.asarray(r_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), **TOL)
    tprim = [_t(a) for a in (q, k, v)] + ([tkb] if kb is not None else [])
    out, vjp_t = torch.func.vjp(
        lambda *a: flash_attention(*a[:3], a[3] if len(a) > 3 else None,
                                   causal, scale, window, tseg), *tprim)
    np.testing.assert_array_equal(out.numpy(), o.numpy())
    grads = vjp_t(_t(do))
    assert len(grads) == len(r_grads)
    for got, want in zip(grads, r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    delta = (_t(do) * o).sum(-1)
    plain = flash_attention_grad_plain(_t(q), _t(k), _t(v), tkb, lse, _t(do),
                                       delta, causal, scale, None, window,
                                       tseg)
    for got, want in zip(plain, r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if window == 1:  # a query sees only itself: o is its own v row
        np.testing.assert_allclose(o.numpy(), v, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("qoff", [0, 128])
def test_flash_piece_window_matches_reference_kernel(qoff):
    """B9 with a window: flash_attention_piece_plain's (o, lse) and the
    autograd wrapper's vjp with cotangents on o and lse against the
    reference's flash_attention_piece (interpret mode, blocks 32), Tq 64
    over Tk 128 at window 48.  At qoff 128 the rows from 47 on see no
    key: both sides keep the lse sentinel there and give those rows zero
    dq (their o is defined-garbage and not compared)."""
    rng = np.random.RandomState(40 + qoff)
    bh, tq, tk, d, scale, window = 3, 64, 128, 16, 0.25, 48
    q = rng.randn(bh, tq, d).astype("float32")
    k = rng.randn(bh, tk, d).astype("float32")
    v = rng.randn(bh, tk, d).astype("float32")
    do = rng.randn(bh, tq, d).astype("float32")
    dlse = rng.randn(bh, tq).astype("float32")
    jqoff = jnp.asarray(np.array([qoff], "int32"))
    (r_o, r_lse), vjp = jax.vjp(
        lambda a, b, c: pk.flash_attention_piece(a, b, c, True, scale, 32,
                                                 32, window, jqoff),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    r_grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    live = (qoff + np.arange(tq)) - (tk - 1) < window
    assert live.all() == (qoff == 0)
    tqoff = torch.tensor([qoff])
    o, lse = flash_attention_piece_plain(_t(q), _t(k), _t(v), True, scale,
                                         tqoff, window)
    np.testing.assert_allclose(o.numpy()[:, live], np.asarray(r_o)[:, live],
                               **TOL)
    np.testing.assert_allclose(lse.numpy()[:, live],
                               np.asarray(r_lse)[:, live], **TOL)
    assert (lse.numpy()[:, ~live] <= NEG_INF / 2).all()
    assert (np.asarray(r_lse)[:, ~live] <= NEG_INF / 2).all()
    out, vjp_t = torch.func.vjp(
        lambda a, b, c: flash_attention_piece(a, b, c, True, scale, tqoff,
                                              window), _t(q), _t(k), _t(v))
    np.testing.assert_array_equal(out[1].numpy(), lse.numpy())
    grads = vjp_t((_t(do), _t(dlse)))
    plain = flash_attention_piece_grad_plain(_t(q), _t(k), _t(v), o, lse,
                                             _t(do), _t(dlse), True, scale,
                                             tqoff, window)
    for got, pl, want in zip(grads, plain, r_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(pl.numpy(), np.asarray(want), **TOL)
    assert float(grads[0][:, ~live].abs().sum()) == 0.0
    # a key no live query reaches takes no gradient either
    first_seen = max(0, qoff - window + 1)
    assert float(grads[1][:, :first_seen].abs().sum()) == 0.0


def test_flash_forms_are_checked_before_a_launch(monkeypatch):
    """On the kernel path the wrappers refuse a window without causal,
    segment ids beside a query base or of the wrong shape, before any
    launch; the plain path refuses the same forms."""
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    q = torch.ones(2, 4, 64)
    row = torch.ones(2, 4)
    seg = torch.ones(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention_fwd(q, q, q, None, False, None, 3)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_dq(q, q, q, None, row, q, row, True, None, 0,
                           seg[:, :3])
    with pytest.raises(ValueError, match="integer"):
        flash_attention_dkv(q, q, q, None, row, q, row, True, None, 0,
                            seg.float())
    with pytest.raises(ValueError, match="segment ids require"):
        flash_attention_plain(q, q, q, None, True, None, torch.tensor([1]),
                              0, seg)
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention_plain(q.clone(), q, q, None, False, None, None, 2)


def _launch_fills_from_plain(monkeypatch):
    """Forces the kernel path on CPU tensors and replays each flash launch
    by the plain versions, reading every operand (the query base, the
    window and the int32 ids included) from the launch's own arguments:
    the wrappers' plumbing runs end to end with no card.  Returns the
    list of (entry point, arguments) launched; any other entry point
    fails the test."""
    monkeypatch.setattr(build, "use_kernel", lambda t: t.device.type == "cpu")
    launched = []

    def launch(name, *args):
        launched.append((name, args))
        q, k, v, kb, qb = args[:5]
        causal, scale, window = bool(args[-5]), args[-3], args[-2]
        seg = None if args[-1] is None else args[-1].long()
        if name == "ptt_flash_attention_fwd":
            o, lse = flash_attention_plain(q, k, v, kb, causal, scale, qb,
                                           window, seg)
            args[5].copy_(o)
            args[6].copy_(lse)
            return
        lse, do, delta = args[5:8]
        dq, dk, dv, dkb = flash_attention_grad_plain(
            q, k, v, kb, lse, do, delta, causal, scale, qb, window, seg)
        if name == "ptt_flash_attention_dq":
            args[8].copy_(dq)
        elif name == "ptt_flash_attention_dkv":
            args[8].copy_(dk)
            args[9].copy_(dv)
            if args[10] is not None:
                args[10].copy_(dkb)
        else:
            pytest.fail("unexpected launch " + name)

    monkeypatch.setattr(build, "launch", launch)
    return launched


def test_flash_kernel_path_carries_window_and_segments(monkeypatch):
    """The autograd wrapper on the kernel path: its forward launch and its
    nested backward's dq and dk/dv launches get the window and the int32
    ids (the launches here replayed by the plain versions), so the vjp
    equals the plain path's."""
    rng = np.random.RandomState(9)
    bh, t, d = 2, 48, 64
    q, k, v, do = (_t(rng.randn(bh, t, d).astype("float32"))
                   for _ in range(4))
    seg = _t(_packed_ids(rng, bh, t, pad=5)).long()
    want_o, vjp = torch.func.vjp(
        lambda a, b, c: flash_attention(a, b, c, None, True, None, 7, seg),
        q, k, v)
    want = vjp(do)
    launched = _launch_fills_from_plain(monkeypatch)
    got_o, vjp = torch.func.vjp(
        lambda a, b, c: flash_attention(a, b, c, None, True, None, 7, seg),
        q, k, v)
    got = vjp(do)
    assert [n for n, _ in launched] == ["ptt_flash_attention_fwd",
                                        "ptt_flash_attention_dq",
                                        "ptt_flash_attention_dkv"]
    assert all(args[-2] == 7 and args[-1].dtype == torch.int32
               for _, args in launched)
    np.testing.assert_array_equal(got_o.numpy(), want_o.numpy())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.cuda
def test_segment_and_window_kernels_match_plain_on_the_card():
    """On a CUDA card: B3's forward, dq and dk/dv with packed segment ids
    (causal, and non-causal with a key bias), a window of 200 at a
    ragged T, window and segments together at head dim 128, and B9 with
    a window at qoff 0 and at a qoff that leaves rows with no key
    (sentinel lse and zero gradients there), against the plain versions
    within 1e-4 of each output's largest magnitude; reruns bit-equal.
    Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    rng = np.random.RandomState(0)

    def close(got, want):
        err = (got - want).abs().max() / want.abs().max().clamp_min(1e-30)
        assert float(err) <= 1e-4

    for bh, t, d, causal, window, with_seg, with_bias in (
            (4, 300, 64, True, 0, True, False),
            (3, 256, 64, False, 0, True, True),
            (3, 1000, 64, True, 200, False, False),
            (2, 384, 128, True, 100, True, False)):
        q, k, v, do = (rnd(bh, t, d) for _ in range(4))
        seg = (torch.tensor(_packed_ids(rng, bh, t, pad=t // 8), device=dev)
               if with_seg else None)
        kb = rnd(bh, t) if with_bias else None
        o, lse = flash_attention_fwd(q, k, v, kb, causal, None, window, seg)
        p_o, p_lse = flash_attention_plain(q, k, v, kb, causal, None, None,
                                           window, seg)
        close(o, p_o)
        assert float((lse - p_lse).abs().max()) <= 1e-4
        _, vjp = torch.func.vjp(
            lambda a, b, c: flash_attention(a, b, c, kb, causal, None,
                                            window, seg), q, k, v)
        grads = vjp(do)
        want = flash_attention_grad_plain(q, k, v, kb, p_lse, do,
                                          (do * p_o).sum(-1), causal, None,
                                          None, window, seg)
        for a, b in zip(grads, want):
            close(a, b)
        assert all(torch.equal(a, b) for a, b in zip(grads, vjp(do)))
    q, k, v, do = rnd(3, 64, 64), rnd(3, 128, 64), rnd(3, 128, 64), \
        rnd(3, 64, 64)
    dlse = rnd(3, 64)
    for off in (0, 128):
        qoff = torch.tensor([off], device=dev)
        live = (off + torch.arange(64, device=dev)) - 127 < 48
        (o, lse), vjp = torch.func.vjp(
            lambda a, b, c: flash_attention_piece(a, b, c, True, None, qoff,
                                                  48), q, k, v)
        p_o, p_lse = flash_attention_piece_plain(q, k, v, True, None, qoff,
                                                 48)
        close(o[:, live], p_o[:, live])
        assert bool((lse[:, ~live] <= NEG_INF / 2).all())
        grads = vjp((do, dlse))
        for a, b in zip(grads, flash_attention_piece_grad_plain(
                q, k, v, o, lse, do, dlse, True, None, qoff, 48)):
            close(a, b)
        assert float(grads[0][:, ~live].abs().sum()) == 0.0
