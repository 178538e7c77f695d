"""bf16 KV caches (cache_dtype="bfloat16") through the port on the CPU,
held against the reference (its Pallas kernels in interpret mode, under
``use_pallas``):

- the one-token, chunked and ragged step programs, and the slot-reset,
  row-copy and beam-reorder programs, built with bf16 caches, equal the
  reference's op for op, their caches bf16;
- the plain versions of the three bf16-KV forms (B3d, B9, B8: a float32 q
  over bf16 k and v) against ``pk._flash_fwd`` / ``pk.flash_attention_piece``
  / ``pk.flash_attention_qvec`` on the same bf16 k and v within 1e-5
  relative: the widening is exact, so this is the float32 tolerance;
- the caches after a chunked prompt prefill equal the reference's in at
  least 99% of their elements (compared as float32) and differ by at most
  one bf16 unit in the last place elsewhere (both round a float32
  projection whose last bits differ);
- greedy (one-token and chunked prefill) and beam-2 decoding over bf16
  caches on a briefly trained, peaky tiny model give the reference's
  tokens, each step's logits within 2^-7 of its largest reference
  magnitude (measured: 1.94e-07 for greedy);
- a churn trace through the bf16 engine: pooled == run_solo bit for bit,
  a prefix hit equals a cold prefill, greedy self-draft speculation
  equals plain decoding, and the pool holds half the f32 engine's bytes;
- the kernel wrappers hand bf16 k and v to the new C entry points
  (a spied ``build.launch``) with the plans' bf16 ints, counted under the
  ``*_kvbf16`` names; a bf16 q, and bf16 k / v to the based backwards,
  raise naming ROADMAP B8q."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pfluid
from paddle_tpu import flags as ref_flags
from paddle_tpu.models import decode_cache as ref_dc
from paddle_tpu.models import gpt2 as ref_gpt2
from paddle_tpu.ops import pallas_kernels as pk
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.models import decode_cache as port_dc
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.serving import Request, ServingEngine

from test_torch_program import _assert_same_program

fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

BF = torch.bfloat16
_HP = dict(vocab_size=61, n_ctx=32, d_model=64, n_layer=2, n_head=4,
           dropout=0.0)
_CONFIGS = {"gpt2": _HP,
            "modern": dict(_HP, n_kv_head=2, use_rotary=True,
                           use_swiglu=True, ffn_multiple_of=8)}
T_MAX, WIDTH = 24, 8
REL = 1e-5  # the plain forms against the Pallas kernels
LOGIT_REL = 2.0 ** -7  # a decode step's logits, of the largest magnitude


def _configs(name, **kw):
    attrs = dict(_CONFIGS[name], **kw)
    return (type("Ref", (ref_gpt2.GPT2Config,), attrs),
            type("Port", (port_gpt2.GPT2Config,), attrs))


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


def _with_pallas(fn):
    """fn() under the reference's use_pallas (its kernels in interpret
    mode)."""
    old = {k: ref_flags.get_flag(k) for k in ("use_pallas", "kernel_autotune")}
    ref_flags.set_flags({"use_pallas": True, "kernel_autotune": False})
    try:
        return fn()
    finally:
        ref_flags.set_flags(old)


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config,width", [("gpt2", 1), ("gpt2", WIDTH),
                                          ("modern", 1), ("modern", WIDTH),
                                          ("gpt2", "ragged"),
                                          ("modern", "ragged")])
def test_bf16_step_programs_match_reference(config, width):
    ref_hp, port_hp = _configs(config)
    if width == "ragged":
        kw = dict(batch=4, t_max=T_MAX, width=4, cache_dtype="bfloat16")
        r = ref_gpt2.gpt2_ragged_step_program(ref_hp, **kw)
        p = port_gpt2.gpt2_ragged_step_program(port_hp, **kw)
    else:
        kw = dict(batch=3, t_max=T_MAX, width=width, cache_dtype="bfloat16")
        r = ref_gpt2.gpt2_decode_step_program(ref_hp, **kw)
        p = port_gpt2.gpt2_decode_step_program(port_hp, **kw)
    _assert_same_program(r[0], p[0])
    _assert_same_program(r[1], p[1])
    assert p[2] == r[2] and p[4] == r[4]
    blk = p[0].global_block()
    assert all(str(blk.vars[n].dtype) == "bfloat16" for n in p[4])
    writes = [o for o in blk.ops
              if o.type in ("seq_cache_write", "slot_cache_write")]
    assert len(writes) == 2 * port_hp.n_layer
    assert all(blk.vars[o.outputs["Out"][0]].dtype == "bfloat16"
               for o in writes)


@pytest.mark.parametrize("which", ["reset", "reset_default", "row_copy",
                                   "reorder"])
def test_bf16_cache_programs_match_reference(which):
    """The slot reset (per-entry dtype and the default), the prefix
    cache's row copy and the beam reorder over bf16 caches: the
    reference's ops, the masked products cast back to bf16."""
    names = ["gpt2_kcache_0", "gpt2_vcache_0"]
    shape = (4, 2, 8, 16)

    def build_(dc):
        if which == "reset":
            return dc.make_slot_reset_program(
                [(n, shape, "bfloat16") for n in names], 4)
        if which == "reset_default":
            return dc.make_slot_reset_program([(n, shape) for n in names], 4,
                                              dtype="bfloat16")
        if which == "row_copy":
            return dc.make_row_copy_program(
                [("pfx_" + n, (2,) + shape[1:], n, shape) for n in names], 4,
                dtype="bfloat16")
        return dc.make_cache_reorder_program(
            [(n, shape, "bfloat16") for n in names], 4)

    with pfluid.unique_name.guard():
        ref = build_(ref_dc)
    port = build_(port_dc)
    _assert_same_program(ref, port)
    types = [o.type for o in port.global_block().ops]
    assert types.count("cast") == (0 if which == "reorder" else 2)
    assert all(str(port.global_block().vars[n].dtype) == "bfloat16"
               for n in names)


def test_bf16_slot_reset_keeps_bf16_and_zeroes_the_slot():
    names = ["c0", "c1"]
    prog = port_dc.make_slot_reset_program([(n, (3, 2, 4, 8)) for n in names],
                                           3, dtype="bfloat16")
    scope = ptt.Scope()
    for n in names:
        scope.set(n, torch.full((3, 2, 4, 8), 1.5, dtype=BF))
    ptt.Executor(ptt.CPUPlace()).run(
        prog, feed={"slot_keep": np.array([1, 0, 1], "float32")},
        fetch_list=[], scope=scope)
    for n in names:
        t = scope.find_var(n)
        assert t.dtype == BF
        assert float(t[1].abs().sum()) == 0.0 and bool((t[[0, 2]] == 1.5).all())


# ---------------------------------------------------------------------------
# the plain bf16-KV forms against the Pallas kernels
# ---------------------------------------------------------------------------
def _bf16_kv(rng, bh, tk, d):
    """k, v as bf16 values: (torch bf16, jax bf16)."""
    out = []
    for _ in range(2):
        t = torch.from_numpy(rng.randn(bh, tk, d).astype("float32")).to(BF)
        out.append((t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)))
    return out


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), err
    return err


@pytest.mark.parametrize("tq", [1, 4])
def test_rows_plain_bf16_kv_matches_reference(tq):
    """The one-token step (Tq 1) and the GQA fold (Tq 4) over a bf16
    cache with decode_pos_mask's key bias, one row wholly masked."""
    rng = np.random.RandomState(60)
    bh, tk, d, scale = 3, 40, 16, 0.25
    q = rng.randn(bh, tq, d).astype("float32")
    (k, jk), (v, jv) = _bf16_kv(rng, bh, tk, d)
    kb = np.where(np.arange(tk)[None, :] <= np.array([[9], [25], [39]]),
                  0.0, -1e30).astype("float32")
    kb[0] = -1e30
    r_o, r_lse = pk._flash_fwd(jnp.asarray(q), jk, jv, jnp.asarray(kb), False,
                               scale, tq, 8)
    o, lse = fa.flash_attention_fwd_rows(torch.from_numpy(q), k, v,
                                         torch.from_numpy(kb), scale)
    assert o.dtype == torch.float32 and np.asarray(r_o).dtype == np.float32
    _close(o.numpy(), r_o)
    _close(lse.numpy(), r_lse)


@pytest.mark.parametrize("qoff", [0, 17])
def test_piece_plain_bf16_kv_matches_reference(qoff):
    """The chunked prefill / speculative verify: q [2, 8, 16] float32 at
    global offset qoff over a bf16 cache of 32 keys."""
    rng = np.random.RandomState(61)
    bh, tq, tk, d, scale = 2, 8, 32, 16, 0.25
    q = rng.randn(bh, tq, d).astype("float32")
    (k, jk), (v, jv) = _bf16_kv(rng, bh, tk, d)
    r_o, r_lse = pk.flash_attention_piece(
        jnp.asarray(q), jk, jv, True, scale, 8, 8, 0,
        jnp.asarray(np.array([qoff], "int32")))
    o, lse = fa.flash_attention_piece_fwd(torch.from_numpy(q), k, v, True,
                                          scale, torch.tensor([qoff]))
    assert o.dtype == torch.float32
    _close(o.numpy(), r_o)
    _close(lse.numpy(), r_lse)


def test_qvec_plain_bf16_kv_matches_reference():
    """The ragged serving step: 6 rows at their own bases over a bf16
    pool, among them 0, mid-cache and Tk - Tq."""
    rng = np.random.RandomState(62)
    tq, tk, d = 4, 16, 8
    qs = np.array([0, 6, 12, 12, 1, 9], "int32")
    bh = len(qs)
    q = rng.randn(bh, tq, d).astype("float32")
    (k, jk), (v, jv) = _bf16_kv(rng, bh, tk, d)
    ref = pk.flash_attention_qvec(jnp.asarray(q), jk, jv, jnp.asarray(qs),
                                  None, tq, 8)
    out = fa.flash_attention_qvec(torch.from_numpy(q), k, v,
                                  torch.from_numpy(qs.astype("int64")))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref)
    # the widened cache gives the same bits: bf16 widens exactly
    wide = fa.flash_attention_qvec(torch.from_numpy(q), k.float(), v.float(),
                                   torch.from_numpy(qs.astype("int64")))
    assert torch.equal(out, wide)


# ---------------------------------------------------------------------------
# the wrappers: the bf16-KV entry points, their plans, the refusals
# ---------------------------------------------------------------------------
def test_bf16_kv_wrappers_launch_their_own_entry_points(monkeypatch):
    """float32 q with bf16 k / v reaches the three *_kvbf16 entry points
    with the bf16 plans' ints (the qvec plan's shared memory from bf16
    rings, the few-row plan's 256-key slices at d 128), counted under
    the *_kvbf16 names; the float32 counters do not move."""
    calls = []
    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: calls.append((name, args)))
    counters = (fa.flash_attention_fwd_rows, fa.flash_attention_piece_fwd,
                fa.flash_attention_qvec, fa.flash_attention_fwd_rows_kvbf16,
                fa.flash_attention_piece_fwd_kvbf16,
                fa.flash_attention_qvec_kvbf16)
    before = {f.__name__: f.launches for f in counters}
    kb = torch.zeros(6, 1024)
    q1, k1 = torch.randn(6, 1, 64), torch.randn(6, 1024, 64).to(BF)
    fa.flash_attention_fwd(q1, k1, k1, kb, False, 0.125)  # the few-row form
    q2, k2 = torch.randn(2, 4, 128), torch.randn(2, 4000, 128).to(BF)
    fa.flash_attention_fwd_rows(q2, k2, k2, None, 0.1)
    q3 = torch.randn(6, 64, 64)
    fa.flash_attention_piece_fwd(q3, k1, k1, True, 0.125,
                                 torch.tensor([192], dtype=torch.int32))
    q4, k4 = torch.randn(8, 16, 64), torch.randn(8, 2048, 64).to(BF)
    fa.flash_attention_qvec(q4, k4, k4, torch.zeros(8, dtype=torch.long))
    assert [c[0] for c in calls] == [
        "ptt_flash_attention_rows_kvbf16", "ptt_flash_attention_rows_kvbf16",
        "ptt_flash_attention_fwd_kvbf16", "ptt_flash_attention_qvec_kvbf16"]
    # BH, Tq, Tk, d, then the plan's ints
    assert list(calls[0][1][8:14]) == [6, 1, 1024, 64,
                                       *fa.rows_plan(1024, 64, BF)]
    assert list(fa.rows_plan(4000, 128, BF)) == [256, 16]
    assert list(fa.rows_plan(4000, 128)) == [128, 32]
    assert list(calls[1][1][8:14]) == [2, 4, 4000, 128, 256, 16]
    assert list(calls[2][1][7:12]) == [6, 64, 1024, 64, fa.FLASH_TC]
    plan = fa.qvec_plan(2048, 64, kv_dtype=BF)
    assert list(calls[3][1][8:16]) == [8, 16, 2048, 64, *plan]
    assert plan.smem == fa.qvec_smem(64, 8, BF) == (
        4 * (2 * 16 * 64 + 8 * 16 * 2) + 2 * 8 * 2 * 2 * 16 * 64)
    assert plan.smem < fa.qvec_plan(2048, 64).smem
    after = {f.__name__: f.launches for f in counters}
    assert {k: after[k] - before[k] for k in after} == {
        "flash_attention_fwd_rows": 0, "flash_attention_piece_fwd": 0,
        "flash_attention_qvec": 0, "flash_attention_fwd_rows_kvbf16": 2,
        "flash_attention_piece_fwd_kvbf16": 1,
        "flash_attention_qvec_kvbf16": 1}
    # a bf16 q, and bf16 k / v to the based backwards, raise before any
    # launch, naming their queue; the tile forward takes no bf16-KV form
    qb = q3.to(BF)
    lse = torch.zeros(6, 64)
    for call in (
            lambda: fa.flash_attention_fwd_rows(q1.to(BF), k1, k1, kb),
            lambda: fa.flash_attention_piece_fwd(qb, k1, k1, True, 0.125,
                                                 torch.tensor([0])),
            lambda: fa.flash_attention_qvec(q4.to(BF), k4, k4,
                                            torch.zeros(8, dtype=torch.long)),
            lambda: fa.flash_attention_piece_dq(q3, k1, k1, lse, q3, lse,
                                                True, 0.125,
                                                torch.tensor([0])),
            lambda: fa.flash_attention_qvec_dkv(q3, k1, k1, lse, q3, lse,
                                                torch.zeros(6))):
        with pytest.raises(build.KernelTypeError, match="B8q"):
            call()
    with pytest.raises(build.KernelTypeError, match="operand 1"):
        fa.flash_attention_fwd(q3, k1, k1, None, True, 0.125)
    assert len(calls) == 4


def test_check_inputs_bf16_kv_rule():
    """The bf16-KV rule: float32 q, bf16 k and v, float32 key bias (and
    o, lse), for the three KV-cache readers only."""
    q, kv = torch.zeros(2, 4, 8), torch.zeros(2, 8, 8, dtype=BF)
    row = torch.zeros(2, 8)
    for name in build.KV_BF16_FORMS:
        build.check_inputs(name, q, kv, kv)
        build.check_inputs(name, q, kv, kv, row)
        assert build.kv_bf16(name, q, kv, kv)
        with pytest.raises(build.KernelTypeError, match="operand 2"):
            build.check_inputs(name, q, kv, kv.float())
        with pytest.raises(build.KernelTypeError, match="operand 3"):
            build.check_inputs(name, q, kv, kv, row.to(BF))
        with pytest.raises(build.KernelTypeError, match="B8q"):
            build.check_inputs(name, q.to(BF), kv, kv)
    assert not build.kv_bf16("flash_attention_fwd", q, kv, kv)
    with pytest.raises(build.KernelTypeError, match="operand 1"):
        build.check_inputs("flash_attention_fwd", q, kv, kv)


# ---------------------------------------------------------------------------
# decoding over bf16 caches, against the reference
# ---------------------------------------------------------------------------
class _Recorder:
    """Keep the fetched logits of every run of the given programs."""

    def __init__(self, exe, *programs):
        self.logits = []
        run = exe.run
        ids = {id(p) for p in programs}

        def recording_run(program=None, feed=None, fetch_list=None, **kw):
            out = run(program, feed=feed, fetch_list=fetch_list, **kw)
            if id(program) in ids:
                self.logits.append(np.asarray(out[0], np.float32))
            return out

        exe.run = recording_run


_PEAKY = dict(vocab_size=8, n_ctx=24, d_model=32, n_layer=2, n_head=4,
              dropout=0.0)
PERIOD = 4


@pytest.fixture(scope="module")
def peaky_weights():
    """A tiny GPT-2 trained 60 Adam steps on a period-4 cycle (the
    reference's own bf16-cache test's recipe): its next-token logits are
    peaky, so a bf16 cache cannot flip a greedy token."""
    hp = type("Ref", (ref_gpt2.GPT2Config,), _PEAKY)
    seq = np.arange(13) % PERIOD
    batch = {"ids": np.tile(seq[:-1], (4, 1)).astype("int64"),
             "labels": np.tile(seq[1:], (4, 1)).astype("int64"),
             "loss_weight": np.ones((4, 12), "float32")}
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()), \
            pfluid.scope_guard(pfluid.Scope()):
        main, startup, _, fetches = ref_gpt2.gpt2_lm_program(hp, seq_len=12,
                                                             lr=1e-2)
        startup.random_seed = 5
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup)
        for _ in range(60):
            exe.run(main, feed=batch, fetch_list=fetches)
        scope = pfluid.global_scope()
        return {n: np.asarray(scope.find_var(n))
                for n in scope.local_var_names()
                if not n.endswith(("_moment1_0", "_moment2_0"))
                and "beta" not in n and "learning_rate" not in n}


class _Decoder:
    """One package's bf16-cache decode programs over the peaky weights."""

    def __init__(self, pkg, gpt2, weights, batch, port):
        hp = type("HP", ((port_gpt2 if port else ref_gpt2).GPT2Config,),
                  _PEAKY)
        self.pkg, self.gpt2 = pkg, gpt2
        self.scope = pkg.Scope()
        self.exe = pkg.Executor(pkg.CPUPlace())
        if port:
            params_from_numpy(weights, self.scope, ptt.CPUPlace())
        else:
            for n, w in weights.items():
                self.scope.set(n, w)
        with pkg.scope_guard(self.scope):
            (self.step, self.start, _, self.fetch,
             self.names) = gpt2.gpt2_decode_step_program(
                 hp, batch=batch, t_max=_PEAKY["n_ctx"],
                 cache_dtype="bfloat16")
            self.wide, _, _, self.wide_fetch, _ = \
                gpt2.gpt2_decode_step_program(
                    hp, batch=batch, t_max=_PEAKY["n_ctx"], width=4,
                    cache_dtype="bfloat16")
        self.rec = _Recorder(self.exe, self.step, self.wide)

    def __call__(self, fn, *args, chunked=True, **kw):
        prefill = ((self.wide, self.wide_fetch, 4, _PEAKY["n_ctx"])
                   if chunked else None)
        with self.pkg.scope_guard(self.scope):
            return fn(self.exe, self.step, self.start, self.fetch, *args,
                      prefill=prefill, **kw)

    def caches(self):
        out = {}
        for n in self.names:
            t = self.scope.find_var(n)
            out[n] = (t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t).astype(np.float32))
        return out


def _both(weights, batch):
    ref = _Decoder(pfluid, ref_gpt2, weights, batch, port=False)
    port = _Decoder(ptt, port_gpt2, weights, batch, port=True)
    return ref, port


def _logits_within(port, ref):
    """The largest step error, of each step's largest reference
    magnitude; asserted within LOGIT_REL."""
    assert len(port) == len(ref) > 0
    worst = 0.0
    for a, b in zip(port, ref):
        assert a.shape == b.shape
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    assert worst <= LOGIT_REL, worst
    return worst


def _prompt(batch):
    return np.tile(np.arange(5) % PERIOD, (batch, 1)).astype("int64")


@pytest.mark.parametrize("chunked", [False, True])
def test_greedy_bf16_cache_matches_reference(peaky_weights, chunked):
    """Greedy over bf16 caches, one-token or chunked prefill: the same
    tokens (the learned cycle) and every step's logits within 2^-7 of
    the reference's largest magnitude; the caches are bf16 in both."""
    ref, port = _both(peaky_weights, 2)
    prompt = _prompt(2)
    r = _with_pallas(lambda: ref(ref_gpt2.greedy_generate_cached, prompt, 8,
                                 chunked=chunked))
    p = port(port_gpt2.greedy_generate_cached, prompt, 8, chunked=chunked)
    np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(p[0], np.arange(13) % PERIOD)
    print("greedy bf16-cache logits: %.3g of the largest magnitude"
          % _logits_within(port.rec.logits, ref.rec.logits))
    assert port.scope.find_var(port.names[0]).dtype == BF
    assert str(np.asarray(ref.scope.find_var(ref.names[0])).dtype) == \
        "bfloat16"


def test_caches_after_a_prompt_match_reference(peaky_weights):
    """After one chunked prefill of a 9-token prompt the bf16 caches
    equal the reference's in at least 99% of their elements, and differ
    by at most one bf16 unit in the last place elsewhere."""
    ref, port = _both(peaky_weights, 2)
    prompt = np.random.RandomState(3).randint(0, 8, (2, 9)).astype("int64")
    _with_pallas(lambda: ref(ref_gpt2.greedy_generate_cached, prompt, 1))
    port(port_gpt2.greedy_generate_cached, prompt, 1)
    rc, pc = ref.caches(), port.caches()
    equal = total = 0
    for n in port.names:
        a, b = pc[n], rc[n]
        equal += int((a == b).sum())
        total += a.size
        mag = np.maximum(np.abs(a), np.abs(b))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(a - b) <= ulp).all(), n
        assert np.abs(a[:, :, :9]).sum() > 0  # the prompt's slots written
    assert equal >= 0.99 * total, equal / total


def test_beam_bf16_cache_matches_reference(peaky_weights):
    """Beam 2 over bf16 caches (the reorder program gathers bf16 rows
    every step): the reference's ids and scores, every step's logits
    within 2^-7."""
    ref, port = _both(peaky_weights, 4)
    prompt = _prompt(2)
    r_ids, r_scores = _with_pallas(lambda: ref(
        ref_gpt2.beam_generate_cached, prompt, 6, beam_size=2))
    p_ids, p_scores = port(port_gpt2.beam_generate_cached, prompt, 6,
                           beam_size=2)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_array_equal(p_ids[0, :11], (np.arange(13) % PERIOD)[:11])
    np.testing.assert_allclose(p_scores, r_scores, rtol=1e-4)
    _logits_within(port.rec.logits, ref.rec.logits)


# ---------------------------------------------------------------------------
# the serving engine over bf16 pools
# ---------------------------------------------------------------------------
def _churn(seed=0, prefix=None):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(8):
        sampled = i % 2 == 1
        prompt = rng.randint(1, 61, int(rng.randint(2, 11)))
        if prefix is not None and i % 3 != 2:
            prompt = np.concatenate([prefix, prompt[:3]])
        reqs.append(Request(
            rid=i, prompt=prompt, max_new_tokens=int(rng.randint(3, 7)),
            temperature=0.9 if sampled else 1.0, top_k=8 if sampled else 0,
            seed=1000 + i if sampled else None, arrival=float(i) * 0.9))
    return reqs


@pytest.fixture(scope="module")
def engine_scope():
    """A scope with seeded tiny GPT-2 weights."""
    _, hp = _configs("gpt2")
    scope = ptt.Scope()
    with ptt.scope_guard(scope), unique_name.guard():
        _, start, _, _ = port_gpt2.gpt2_logits_program(hp, seq_len=24)
        start.random_seed = 7
        ptt.Executor(ptt.CPUPlace()).run(start)
    return hp, scope


def test_bf16_engine_pooled_equals_solo_and_halves_the_pool(engine_scope):
    hp, scope = engine_scope
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        eng = ServingEngine(exe, hp, n_slots=4, width=4, t_max=24,
                            cache_dtype="bfloat16")
        pooled, stats = eng.run(_churn())
        assert stats["finished"] == 8
        assert scope.find_var(eng.cache_names[0]).dtype == BF
        plans = exe.compile_count
        for req in _churn():
            solo, _ = eng.run_solo(req)
            np.testing.assert_array_equal(pooled[req.rid]["tokens"], solo)
        assert exe.compile_count == plans
        kv16 = eng.kv_pool_bytes(scope)
        f32 = ServingEngine(exe, hp, n_slots=4, width=4, t_max=24)
        f32.run(_churn()[:1])
        kv32 = f32.kv_pool_bytes(scope)
    assert 2 * kv16["total_bytes"] == kv32["total_bytes"] == (
        2 * hp.n_layer * 4 * hp.n_head * 24 * (hp.d_model // hp.n_head) * 4)


def test_bf16_engine_prefix_hit_equals_cold(engine_scope):
    hp, scope = engine_scope
    prefix = np.arange(1, 13, dtype="int64")
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        eng = ServingEngine(exe, hp, n_slots=4, width=4, t_max=24,
                            cache_dtype="bfloat16", prefix_rows=2,
                            prefix_chunk=4)
        assert eng.register_prefix(prefix) is not None
        bank = eng.prefix.banks[0]
        assert "cast" in [o.type for o in bank.load_prog.global_block().ops]
        warm, wst = eng.run(_churn(5, prefix))
        cold_eng = ServingEngine(exe, hp, n_slots=4, width=4, t_max=24,
                                 cache_dtype="bfloat16")
        cold, cst = cold_eng.run(_churn(5, prefix))
        assert scope.find_var("pfx_" + eng.cache_names[0]).dtype == BF
    assert wst["prefix_hits"] >= 4 and cst["prefix_hits"] == 0
    assert wst["prefill_chunks"] < cst["prefill_chunks"]
    for rid in cold:
        np.testing.assert_array_equal(warm[rid]["tokens"], cold[rid]["tokens"])


def test_bf16_engine_self_draft_speculation_equals_plain(engine_scope):
    """Greedy requests through a self-draft engine (draft pool bf16 too)
    emit the plain engine's tokens."""
    hp, scope = engine_scope
    reqs = [r for r in _churn(2) if r.seed is None]
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        plain, _ = ServingEngine(exe, hp, n_slots=4, width=4, t_max=24,
                                 cache_dtype="bfloat16").run(reqs)
        spec = ServingEngine(exe, hp, n_slots=4, width=4, t_max=24,
                             cache_dtype="bfloat16", draft="self", spec_k=3)
        out, st = spec.run([r for r in _churn(2) if r.seed is None])
        assert scope.find_var(spec.draft_cache_names[0]).dtype == BF
    assert st["spec_rounds"] > 0
    for rid in plain:
        np.testing.assert_array_equal(out[rid]["tokens"], plain[rid]["tokens"])
