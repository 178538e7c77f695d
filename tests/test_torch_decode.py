"""KV-cached GPT-2 decoding through the port on the CPU, held against the
reference: a narrow GPT-2 (vocab 61, n_ctx 32, d_model 64, 2 layers, 4
heads, dropout 0) and a narrow modern config (the same with 2 kv heads,
rotary positions and SwiGLU), weights from a seeded reference startup
carried by name (io.params_from_numpy).

- gpt2_decode_step_program at width 1 and width W builds the reference's
  program (op types, slots, names, attrs, var shapes) with its cache
  startup;
- seq_cache_write (Pos clamped into [0, T - W], as dynamic_update_slice
  clamps) and decode_pos_mask against the reference lowerings;
- greedy_generate_cached with one-token and chunked prefill, seeded
  sample_generate_cached (top-k, top-p), beam_generate_cached (ids and
  scores, the cache reorder program every step), greedy_generate and
  beam_generate on the logits program: every step's logits within 1e-5
  of the largest logit magnitude of the reference's, and the same
  tokens (the reference's top-2 margins are checked to exceed twice
  that tolerance, so no near tie decides a greedy token);
- the reference's own contracts inside the port: chunked prefill's
  logits equal one-token prefill's, and cached greedy equals uncached
  greedy token for token.

The tests that run the reference's cached loops twice or over both
configs are marked slow; the fast ones take a few seconds each."""

import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu.models import gpt2 as ref_gpt2
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import gpt2 as port_gpt2

from test_torch_ops import _run_both
from test_torch_program import _assert_same_program

_HP = dict(vocab_size=61, n_ctx=32, d_model=64, n_layer=2, n_head=4,
           dropout=0.0)
_CONFIGS = {
    "gpt2": _HP,
    "modern": dict(_HP, n_kv_head=2, use_rotary=True, use_swiglu=True,
                   ffn_multiple_of=8),
    "tied": dict(_HP, tie_embeddings=True),
}
T_MAX, WIDTH = 24, 8
REL = 1e-5  # of each step's largest reference logit magnitude


def _configs(name):
    return (type("Ref", (ref_gpt2.GPT2Config,), _CONFIGS[name]),
            type("Port", (port_gpt2.GPT2Config,), _CONFIGS[name]))


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


@pytest.mark.parametrize("config,width", [("gpt2", 1), ("gpt2", WIDTH),
                                          ("modern", 1), ("modern", WIDTH),
                                          ("tied", 1)])
def test_decode_step_program_matches_reference(config, width):
    ref_hp, port_hp = _configs(config)
    kw = dict(batch=3, t_max=T_MAX, width=width)
    r = ref_gpt2.gpt2_decode_step_program(ref_hp, **kw)
    p = port_gpt2.gpt2_decode_step_program(port_hp, **kw)
    _assert_same_program(r[0], p[0])
    _assert_same_program(r[1], p[1])
    assert p[2] == r[2] and p[4] == r[4]
    assert p[3][0].name == r[3][0].name
    types = [o.type for o in p[0].global_block().ops]
    assert types.count("seq_cache_write") == 2 * port_hp.n_layer
    attn = [o for o in p[0].global_block().ops if o.type == "fused_attention"]
    if width > 1:  # the scalar-QStart form: flash_attention_piece
        assert all(o.inputs["QStart"] == ["pos"] for o in attn)
        assert "decode_pos_mask" not in types
    else:  # the key-bias form at Tq 1 (Tq g with the GQA fold)
        assert all("QStart" not in o.inputs and o.inputs["Bias"]
                   for o in attn)
        assert types.count("decode_pos_mask") == port_hp.n_layer


def test_decode_step_program_refuses_bf16_caches():
    _, port_hp = _configs("gpt2")
    with pytest.raises(NotImplementedError, match="A3"):
        port_gpt2.gpt2_decode_step_program(port_hp, cache_dtype="bfloat16")


@pytest.mark.parametrize("pos,width", [(0, 1), (5, 1), (3, 4), (7, 1),
                                       (6, 4), (9, 4)])
def test_seq_cache_write_matches_reference(pos, width):
    """Pos past T - W clamps to T - W (6 and 9 with W 4 over T 8)."""
    rng = np.random.RandomState(40)
    ins = {"Cache": [rng.randn(2, 3, 8, 5).astype("float32")],
           "New": [rng.randn(2, 3, width, 5).astype("float32")],
           "Pos": [np.array([pos], "int64")]}
    ref, out = _run_both("seq_cache_write", ins, {})
    np.testing.assert_array_equal(out["Out"][0], ref["Out"][0])
    lo = min(pos, 8 - width)
    np.testing.assert_array_equal(out["Out"][0][:, :, lo:lo + width],
                                  ins["New"][0])


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_pos_mask_matches_reference(pos):
    ref, out = _run_both("decode_pos_mask", {"Pos": [np.array([pos], "int64")]},
                         {"t_max": 12, "batch": 3})
    np.testing.assert_array_equal(out["Out"][0], ref["Out"][0])
    assert out["Out"][0].shape == (3, 12)


# ---------------------------------------------------------------------------
# the generation loops, both packages from the same weights
# ---------------------------------------------------------------------------
class _Recorder:
    """Wrap an executor's run: keep the fetched logits of every run of
    the given programs, in order."""

    def __init__(self, exe, *programs):
        self.logits = []
        run = exe.run
        ids = {id(p) for p in programs if p is not None}

        def recording_run(program=None, feed=None, fetch_list=None, **kw):
            out = run(program, feed=feed, fetch_list=fetch_list, **kw)
            if id(program) in ids:
                self.logits.append(np.asarray(out[0]))
            return out

        exe.run = recording_run


class _Side:
    """One package's executor, scope and decode programs."""

    def __init__(self, pkg, gpt2, hp, exe, scope, batch, logits_len=None):
        self.pkg, self.exe, self.scope = pkg, exe, scope
        with pkg.scope_guard(scope):
            (self.step, self.cache_start, _, self.fetch,
             _) = gpt2.gpt2_decode_step_program(hp, batch=batch, t_max=T_MAX)
            self.wide, _, _, self.wide_fetch, _ = \
                gpt2.gpt2_decode_step_program(hp, batch=batch, t_max=T_MAX,
                                              width=WIDTH)
            if logits_len:
                self.logits_main, _, _, self.logits_fetch = \
                    gpt2.gpt2_logits_program(hp, seq_len=logits_len)
        self.rec = _Recorder(exe, self.step, self.wide,
                             getattr(self, "logits_main", None))

    def prefill(self, chunked):
        return ((self.wide, self.wide_fetch, WIDTH, T_MAX) if chunked
                else None)

    def __call__(self, fn, *args, **kw):
        with self.pkg.scope_guard(self.scope):
            return fn(self.exe, *args, **kw)


def _sides(config, batch, logits_len=None, seed=7):
    """(reference side, port side) over the same seeded weights."""
    ref_hp, port_hp = _configs(config)
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        _, start, _, _ = ref_gpt2.gpt2_logits_program(ref_hp, seq_len=T_MAX)
        start.random_seed = seed
        ref_exe = pfluid.Executor(pfluid.CPUPlace())
        ref_exe.run(start)
        weights = {n: np.asarray(scope.find_var(n))
                   for n in scope.local_var_names()}
        ref = _Side(pfluid, ref_gpt2, ref_hp, ref_exe, scope, batch,
                    logits_len)
    port_scope = ptt.Scope()
    params_from_numpy(weights, port_scope, ptt.CPUPlace())
    port = _Side(ptt, port_gpt2, port_hp, ptt.Executor(ptt.CPUPlace()),
                 port_scope, batch, logits_len)
    return ref, port


def _prompts(batch, p, seed=11):
    return np.random.RandomState(seed).randint(1, 61, (batch, p)).astype(
        "int64")


def _assert_logits_close(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        assert err <= REL * float(np.abs(b).max()), (i, err)


def _assert_clear_margins(logits):
    """No near tie decides a greedy token: the top-2 gap of every row
    exceeds twice the logits' tolerance, so logits within it pick the
    same token."""
    for lg in logits:
        rows = lg.reshape(-1, lg.shape[-1])
        top2 = np.sort(rows, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        assert (gap > 2 * REL * np.abs(rows).max(-1)).all(), gap.min()


@pytest.mark.parametrize("config,chunked", [
    ("gpt2", False), ("gpt2", True),
    pytest.param("modern", False, marks=pytest.mark.slow),
    ("modern", True)])
def test_greedy_cached_matches_reference(config, chunked):
    """Prompt 11 (chunked: two width-8 runs, the last re-anchored to
    T - W), 9 new tokens: every step's logits and the tokens."""
    ref, port = _sides(config, batch=2)
    prompt = _prompts(2, 11)
    r = ref(ref_gpt2.greedy_generate_cached, ref.step, ref.cache_start,
            ref.fetch, prompt, 9, prefill=ref.prefill(chunked))
    p = port(port_gpt2.greedy_generate_cached, port.step, port.cache_start,
             port.fetch, prompt, 9, prefill=port.prefill(chunked))
    _assert_clear_margins(ref.rec.logits)
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p, r)
    assert p.shape == (2, 20)


def test_sample_cached_matches_reference():
    """Seeded top-k 8, top-p 0.9, temperature 0.8 after chunked prefill:
    the same logits give the same probabilities, so the same numpy
    draws."""
    ref, port = _sides("modern", batch=3)
    prompt = _prompts(3, 5)
    kw = dict(temperature=0.8, top_k=8, top_p=0.9, seed=3)
    r = ref(ref_gpt2.sample_generate_cached, ref.step, ref.cache_start,
            ref.fetch, prompt, 10, prefill=ref.prefill(True), **kw)
    p = port(port_gpt2.sample_generate_cached, port.step, port.cache_start,
             port.fetch, prompt, 10, prefill=port.prefill(True), **kw)
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("config", [
    "gpt2", pytest.param("modern", marks=pytest.mark.slow)])
def test_beam_cached_matches_reference(config):
    """Beam 3 over 2 prompts (step and wide programs at batch 6): the
    reorder program shuffles the caches every step; ids equal, scores
    within 1e-5."""
    ref, port = _sides(config, batch=6)
    prompt = _prompts(2, 6)
    kw = dict(beam_size=3, length_penalty=0.6)
    r_ids, r_scores = ref(ref_gpt2.beam_generate_cached, ref.step,
                          ref.cache_start, ref.fetch, prompt, 8,
                          prefill=ref.prefill(True), **kw)
    p_ids, p_scores = port(port_gpt2.beam_generate_cached, port.step,
                           port.cache_start, port.fetch, prompt, 8,
                           prefill=port.prefill(True), **kw)
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_allclose(p_scores, r_scores, rtol=1e-5)
    assert np.isfinite(p_scores).all() and p_ids.shape == (2, 14)


@pytest.mark.slow
def test_uncached_greedy_and_beam_match_reference():
    """greedy_generate and beam_generate on the logits program (seq_len
    16): every run's logits, the tokens, and the beam scores."""
    ref, port = _sides("gpt2", batch=2, logits_len=16)
    prompt = _prompts(2, 5)
    r = ref(ref_gpt2.greedy_generate, ref.logits_main, ref.logits_fetch,
            prompt, 7)
    p = port(port_gpt2.greedy_generate, port.logits_main, port.logits_fetch,
             prompt, 7)
    np.testing.assert_array_equal(p, r)
    r_ids, r_scores = ref(ref_gpt2.beam_generate, ref.logits_main,
                          ref.logits_fetch, prompt, 6, beam_size=3)
    p_ids, p_scores = port(port_gpt2.beam_generate, port.logits_main,
                           port.logits_fetch, prompt, 6, beam_size=3)
    _assert_clear_margins([lg[:, 4:12] for lg in ref.rec.logits[:7]])
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_allclose(p_scores, r_scores, rtol=1e-5)


def test_port_chunked_prefill_equals_one_token_prefill():
    """The reference's contract inside the port: the logits predicting
    position P after chunked prefill (ceil(11 / 8) width-8 runs) equal
    those after 11 one-token steps, for the modern config (rotary on
    pos_vec vs pos, the GQA fold vs repeat_kv)."""
    _, port_hp = _configs("modern")
    weights_scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(weights_scope):
        _, start, _, _ = port_gpt2.gpt2_logits_program(port_hp, seq_len=T_MAX)
        start.random_seed = 9
        exe.run(start)
        step, cache_start, _, fetch, _ = port_gpt2.gpt2_decode_step_program(
            port_hp, batch=2, t_max=T_MAX)
        wide, _, _, wide_fetch, _ = port_gpt2.gpt2_decode_step_program(
            port_hp, batch=2, t_max=T_MAX, width=WIDTH)
        prompt = _prompts(2, 11, seed=5)
        exe.run(cache_start)
        one = port_gpt2._prefill_cached(exe, step, fetch, prompt)
        exe.run(cache_start)
        chunked = port_gpt2.prefill_cached_chunked(exe, wide, wide_fetch,
                                                   prompt, WIDTH, T_MAX)
    assert chunked.shape == one.shape == (2, 61)
    assert float(np.abs(chunked - one).max()) <= REL * float(np.abs(one).max())


def test_port_cached_greedy_equals_uncached_greedy():
    """Cached greedy (chunked prefill) equals greedy_generate on the
    logits program token for token."""
    _, port_hp = _configs("gpt2")
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        logits_main, start, _, logits_fetch = port_gpt2.gpt2_logits_program(
            port_hp, seq_len=T_MAX)
        start.random_seed = 13
        exe.run(start)
        step, cache_start, _, fetch, _ = port_gpt2.gpt2_decode_step_program(
            port_hp, batch=2, t_max=T_MAX)
        wide, _, _, wide_fetch, _ = port_gpt2.gpt2_decode_step_program(
            port_hp, batch=2, t_max=T_MAX, width=WIDTH)
        prompt = _prompts(2, 9, seed=6)
        cached = port_gpt2.greedy_generate_cached(
            exe, step, cache_start, fetch, prompt, 12,
            prefill=(wide, wide_fetch, WIDTH, T_MAX))
        uncached = port_gpt2.greedy_generate(exe, logits_main, logits_fetch,
                                             prompt, 12)
    np.testing.assert_array_equal(cached, uncached)


def test_cached_calls_are_validated():
    """The prologue checks: the step program's static batch, the cache
    capacity, and a wide program of another cache length."""
    _, port_hp = _configs("gpt2")
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        _, start, _, _ = port_gpt2.gpt2_logits_program(port_hp, seq_len=8)
        exe.run(start)
        step, cache_start, _, fetch, _ = port_gpt2.gpt2_decode_step_program(
            port_hp, batch=2, t_max=T_MAX)
        wide, _, _, wide_fetch, _ = port_gpt2.gpt2_decode_step_program(
            port_hp, batch=2, t_max=16, width=4)
        with pytest.raises(ValueError, match="static batch"):
            port_gpt2.greedy_generate_cached(exe, step, cache_start, fetch,
                                             _prompts(3, 4), 2)
        with pytest.raises(ValueError, match="exceeds cache length"):
            port_gpt2.greedy_generate_cached(exe, step, cache_start, fetch,
                                             _prompts(2, 20), 6)
        with pytest.raises(ValueError, match="cache length"):
            port_gpt2.greedy_generate_cached(
                exe, step, cache_start, fetch, _prompts(2, 4), 2,
                prefill=(wide, wide_fetch, 4, 16))


def test_decode_step_reaches_the_attention_kernels(monkeypatch):
    """The one-token step's attention reaches flash_attention (B3's key
    bias form at Tq 1, and at Tq g under the GQA fold) and the wide
    step's flash_attention_piece (B9), with the position as a tensor,
    never read on the host."""
    from paddle_tpu_torch.ops import nn_ops

    seen = []
    real_flash, real_piece = nn_ops.flash_attention, nn_ops.flash_attention_piece

    def flash(q, k, v, kbias, causal, scale, window, seg):
        assert window == 0 and seg is None
        seen.append(("flash", tuple(q.shape), kbias is not None, causal))
        return real_flash(q, k, v, kbias, causal, scale, window, seg)

    def piece(q, k, v, causal, scale, qoff, window):
        assert torch.is_tensor(qoff) and qoff.numel() == 1
        seen.append(("piece", tuple(q.shape), causal))
        return real_piece(q, k, v, causal, scale, qoff, window)

    monkeypatch.setattr(nn_ops, "flash_attention", flash)
    monkeypatch.setattr(nn_ops, "flash_attention_piece", piece)
    _, port_hp = _configs("modern")
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        _, start, _, _ = port_gpt2.gpt2_logits_program(port_hp, seq_len=8)
        exe.run(start)
        progs = [port_gpt2.gpt2_decode_step_program(port_hp, batch=2,
                                                    t_max=16, width=width)
                 for width in (1, 4)]
        seen.clear()  # building inferred shapes through the same rules
        for width, (step, cache_start, _, fetch, _) in zip((1, 4), progs):
            exe.run(cache_start)
            feed = {"step_ids": _prompts(2, width), "pos": np.array([3])}
            if width > 1:
                feed["pos_vec"] = np.arange(3, 3 + width)
            (lg,) = exe.run(step, feed=feed, fetch_list=fetch)
            assert np.isfinite(lg).all()
    # 2 layers each: heads n_kv 2 with the g = 2 query heads on Tq, then
    # the chunk's repeat_kv'd 4 heads at Tq 4
    assert seen == [("flash", (4, 2, 16), True, False)] * 2 + [
        ("piece", (8, 4, 16), True)] * 2
