"""Transformer translation through the port on the CPU, held against the
reference: a narrow Transformer (source vocab 40, target vocab 37,
max_length 16, d_model 32, 2 heads, 2 + 2 layers, dropout 0), weights
from a seeded reference startup of transformer_logits_program carried
by name (io.params_from_numpy).

- transformer_decode_programs (enc_main, step_main, cache_startup) at
  width 1 and 4, at a beam batch, with fused_attn on and off, and
  transformer_logits_program in both variants build the reference's
  programs (op types, slots, names, attrs, var shapes); the split
  build's persistable names equal the full build's;
- greedy_translate_cached, greedy_translate, beam_translate_cached,
  beam_translate and the seeded sample_translate_cached against the
  reference: every step's logits within 1e-5 of the largest logit
  magnitude, the same tokens (the reference's top-2 margins are checked
  to exceed twice that tolerance), beam scores within 1e-5;
- force_decode_logits_cached at (W, t_max) = (3, T), (4, T), (4, 12)
  against the reference and against one-token stepping (rtol 2e-4,
  atol 2e-5, the reference's own test's tolerances);
- the port's own contracts: cached greedy equals full re-decode greedy,
  cached beam equals full beam, and a second translate of another source
  batch through one executor equals a fresh executor's bit for bit."""

import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu.models import transformer as ref_tfm
import paddle_tpu_torch as ptt
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import transformer as port_tfm

from test_torch_decode import (_assert_clear_margins, _assert_logits_close,
                               _Recorder, fresh_port_state)  # noqa: F401
from test_torch_program import _assert_same_program

_HP = dict(src_vocab_size=40, trg_vocab_size=37, max_length=16, d_model=32,
           d_inner_hid=64, n_head=2, n_layer=2, dropout=0.0)
TS, TT = 8, 12  # source length, target length (the caches' t_max)
BOS, EOS = 1, 36


def _configs(fused=True, **kw):
    attrs = dict(_HP, fused_attn=fused, **kw)
    return (type("Ref", (ref_tfm.ModelHyperParams,), attrs),
            type("Port", (port_tfm.ModelHyperParams,), attrs))


def _persistable_names(programs):
    return {n for prog in programs for n, v in prog.global_block().vars.items()
            if v.persistable}


@pytest.mark.parametrize("fused,width,batch", [
    (False, 1, 2), (True, 1, 2), (False, 4, 2), (True, 4, 2), (True, 1, 6)])
def test_decode_programs_match_reference(fused, width, batch):
    ref_hp, port_hp = _configs(fused)
    kw = dict(batch=batch, src_len=TS, t_max=TT, width=width)
    r = ref_tfm.transformer_decode_programs(ref_hp, **kw)
    p = port_tfm.transformer_decode_programs(port_hp, **kw)
    for rp, pp in zip(r[:3], p[:3]):
        _assert_same_program(rp, pp)
    assert p[3:6] == r[3:6]
    assert p[6][0].name == r[6][0].name
    assert tuple(p[6][0].shape) == (
        (batch, 37) if width == 1 else (batch, width, 37))
    ops = p[1].global_block().ops
    types = [o.type for o in ops]
    attn = [o for o in ops if o.type == "fused_attention"]
    assert len(attn) == 2 * port_hp.n_layer
    self_attn, cross = attn[0::2], attn[1::2]
    assert all(o.inputs["Bias"] == ["tfm_cross_kpad_cache"]
               and "QStart" not in o.inputs for o in cross)
    if width > 1:  # the scalar-QStart form: flash_attention_piece
        assert all(o.inputs["QStart"] == ["pos"] for o in self_attn)
        assert "decode_pos_mask" not in types
    else:  # the <=pos key bias at Tq 1
        assert types.count("decode_pos_mask") == port_hp.n_layer
    # no fuse pass, as in the reference: the projections stay mul ops
    # (no matmul_bias_act launch) and each add + layer_norm apart
    assert "layer_norm" in types and "fused_residual_ln" not in types
    assert "fc" not in types and "mul" in types
    assert types.count("seq_cache_write") == 2 * port_hp.n_layer


@pytest.mark.parametrize("fused", [False, True])
def test_logits_program_matches_reference(fused):
    ref_hp, port_hp = _configs(fused)
    r = ref_tfm.transformer_logits_program(ref_hp, src_len=TS, trg_len=TT)
    p = port_tfm.transformer_logits_program(port_hp, src_len=TS, trg_len=TT)
    _assert_same_program(r[0], p[0])
    _assert_same_program(r[1], p[1])
    assert p[2] == r[2] and p[3][0].name == r[3][0].name
    # the split build's weights are the full build's, by name
    split = port_tfm.transformer_decode_programs(port_hp, batch=2,
                                                 src_len=TS, t_max=TT)
    weights = {n for n in _persistable_names(split[:2]) if "cache" not in n}
    assert weights == _persistable_names([p[0]])
    assert _persistable_names(split[:2]) - weights == {
        "tfm_enc_out_cache", "tfm_cross_kpad_cache"} | {
        "tfm_%scache_%d" % (kv, i) for kv in "kv" for i in range(2)}


def test_decoder_layer_training_form_unchanged():
    """decoder_layer without a cache builds what wmt_transformer_program
    built before the cache form: the reference's training program."""
    for fused in (False, True):
        ref_hp, port_hp = _configs(fused)
        r = ref_tfm.wmt_transformer_program(ref_hp, src_len=TS, trg_len=TT)
        p = port_tfm.wmt_transformer_program(port_hp, src_len=TS, trg_len=TT)
        _assert_same_program(r[0], p[0])


# ---------------------------------------------------------------------------
# the translate loops, both packages from the same weights
# ---------------------------------------------------------------------------
class _Side:
    """One package's executor, scope and programs: the logits program
    and the decode programs at the given batch and width."""

    def __init__(self, pkg, tfm, hp, exe, scope, batch, width=1, t_max=TT):
        self.pkg, self.exe, self.scope = pkg, exe, scope
        with pkg.scope_guard(scope):
            self.logits_main, _, _, self.logits_fetch = \
                tfm.transformer_logits_program(hp, src_len=TS, trg_len=t_max)
            self.programs = tfm.transformer_decode_programs(
                hp, batch=batch, src_len=TS, t_max=t_max, width=width)
        self.rec = _Recorder(exe, self.programs[1], self.logits_main)

    def __call__(self, fn, *args, **kw):
        with self.pkg.scope_guard(self.scope):
            return fn(self.exe, *args, **kw)


def _sides(batch, width=1, t_max=TT, fused=True, seed=3):
    """(reference side, port side) over the same seeded weights."""
    ref_hp, port_hp = _configs(fused)
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        _, start, _, _ = ref_tfm.transformer_logits_program(
            ref_hp, src_len=TS, trg_len=t_max)
        start.random_seed = seed
        ref_exe = pfluid.Executor(pfluid.CPUPlace())
        ref_exe.run(start)
        weights = {n: np.asarray(scope.find_var(n))
                   for n in scope.local_var_names()}
    ref = _Side(pfluid, ref_tfm, ref_hp, ref_exe, scope, batch, width, t_max)
    port_scope = ptt.Scope()
    params_from_numpy(weights, port_scope, ptt.CPUPlace())
    port = _Side(ptt, port_tfm, port_hp, ptt.Executor(ptt.CPUPlace()),
                 port_scope, batch, width, t_max)
    return ref, port


def _source(batch, seed=3):
    """Seeded source rows of ragged lengths (the tail padded with 0)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, 40, (batch, TS)).astype("int64")
    lens = rng.randint(TS // 2, TS + 1, batch)
    lens[0] = TS
    for i, n in enumerate(lens):
        src[i, n:] = 0
    return src, lens


@pytest.mark.parametrize("fused", [True, False])
def test_greedy_translate_cached_matches_reference(fused):
    ref, port = _sides(batch=3, fused=fused)
    src, lens = _source(3)
    r = ref(ref_tfm.greedy_translate_cached, ref.programs, src, lens, BOS,
            EOS)
    p = port(port_tfm.greedy_translate_cached, port.programs, src, lens, BOS,
             EOS)
    _assert_clear_margins(ref.rec.logits)
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p, r)
    assert p.shape == (3, TT) and (p[:, 0] == BOS).all()


def test_greedy_translate_matches_reference():
    """The full re-decode loop on the logits program: every run's logits
    (the whole [B, Tt, V]), the tokens."""
    ref, port = _sides(batch=3)
    src, lens = _source(3, seed=4)
    r = ref(ref_tfm.greedy_translate, ref.logits_main, ref.logits_fetch,
            src, lens, BOS, EOS, max_out_len=9)
    p = port(port_tfm.greedy_translate, port.logits_main, port.logits_fetch,
             src, lens, BOS, EOS, max_out_len=9)
    _assert_clear_margins([lg[:, c] for c, lg in enumerate(ref.rec.logits)])
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p, r)
    assert p.shape == (3, 9)


def test_beam_translate_cached_matches_reference():
    """Beam 3 over 2 sentences (decode programs at batch 6): the reorder
    program shuffles the self-attention caches every step."""
    ref, port = _sides(batch=6)
    src, lens = _source(2, seed=5)
    kw = dict(beam_size=3, length_penalty=0.6)
    r_ids, r_sc = ref(ref_tfm.beam_translate_cached, ref.programs, src,
                      lens, BOS, EOS, **kw)
    p_ids, p_sc = port(port_tfm.beam_translate_cached, port.programs, src,
                       lens, BOS, EOS, **kw)
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_allclose(p_sc, r_sc, rtol=1e-5)
    assert np.isfinite(p_sc).all() and p_ids.shape[0] == 2


def test_beam_translate_matches_reference():
    ref, port = _sides(batch=6)
    src, lens = _source(2, seed=6)
    kw = dict(beam_size=3, max_out_len=8)
    r_ids, r_sc = ref(ref_tfm.beam_translate, ref.logits_main,
                      ref.logits_fetch, src, lens, BOS, EOS, **kw)
    p_ids, p_sc = port(port_tfm.beam_translate, port.logits_main,
                       port.logits_fetch, src, lens, BOS, EOS, **kw)
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_allclose(p_sc, r_sc, rtol=1e-5)


def test_sample_translate_cached_matches_reference():
    """One seed, temperature 0.8, top-k 10, top-p 0.9: the same logits
    give the same probabilities, so the same host numpy draws."""
    ref, port = _sides(batch=3)
    src, lens = _source(3, seed=8)
    kw = dict(temperature=0.8, top_k=10, top_p=0.9, seed=3)
    r = ref(ref_tfm.sample_translate_cached, ref.programs, src, lens, BOS,
            EOS, **kw)
    p = port(port_tfm.sample_translate_cached, port.programs, src, lens, BOS,
             EOS, **kw)
    _assert_logits_close(port.rec.logits, ref.rec.logits)
    np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("width,t_max", [(3, 10), (4, 10), (4, 12)])
def test_force_decode_matches_reference_and_stepping(width, t_max):
    """T 10 targets: t_max == T re-anchors the last chunk, t_max 12 pads
    it.  The port against the reference, and against its own one-token
    cached steps."""
    T = 10
    ref, port = _sides(batch=2, width=width, t_max=t_max, fused=False)
    src, lens = _source(2, seed=4)
    trg = np.random.RandomState(4).randint(1, 37, (2, T)).astype("int64")
    r = ref(ref_tfm.force_decode_logits_cached, ref.programs, src, lens, trg)
    p = port(port_tfm.force_decode_logits_cached, port.programs, src, lens,
             trg)
    assert p.shape == r.shape == (2, T, 37)
    np.testing.assert_allclose(p, r, rtol=2e-4, atol=2e-5)
    exe = port.exe
    with ptt.scope_guard(port.scope):
        (enc_main, step_main, cache_startup, _, _, _, step_fetch) = \
            port_tfm.transformer_decode_programs(
                _configs(False)[1], batch=2, src_len=TS, t_max=t_max)
        exe.run(cache_startup)
        exe.run(enc_main, feed={"src_word": src,
                                "src_slf_attn_bias": port_tfm.pad_bias(
                                    lens, TS)}, fetch_list=[])
        for t in range(T):
            (lg,) = exe.run(step_main, feed={
                "trg_tok": trg[:, t:t + 1], "pos": np.array([t], "int64")},
                fetch_list=step_fetch)
            np.testing.assert_allclose(p[:, t], lg, rtol=2e-4, atol=2e-5,
                                       err_msg="W=%d t=%d" % (width, t))


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------
def _port_only(batch, seed=13, fused=True):
    _, port_hp = _configs(fused)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        main, start, _, fetch = port_tfm.transformer_logits_program(
            port_hp, src_len=TS, trg_len=TT)
        start.random_seed = seed
        exe.run(start)
        programs = port_tfm.transformer_decode_programs(
            port_hp, batch=batch, src_len=TS, t_max=TT)
    return exe, scope, main, fetch, programs


def test_port_cached_greedy_equals_full_greedy():
    exe, scope, main, fetch, programs = _port_only(batch=3)
    src, lens = _source(3, seed=9)
    with ptt.scope_guard(scope):
        full = port_tfm.greedy_translate(exe, main, fetch, src, lens, BOS,
                                         EOS)
        cached = port_tfm.greedy_translate_cached(exe, programs, src, lens,
                                                  BOS, EOS)
    assert cached.shape == full.shape
    np.testing.assert_array_equal(cached, full)


def test_port_cached_beam_equals_full_beam():
    exe, scope, main, fetch, programs = _port_only(batch=6, seed=17)
    src, lens = _source(2, seed=10)
    kw = dict(beam_size=3, max_out_len=10)
    with ptt.scope_guard(scope):
        f_ids, f_sc = port_tfm.beam_translate(exe, main, fetch, src, lens,
                                              BOS, EOS, **kw)
        c_ids, c_sc = port_tfm.beam_translate_cached(exe, programs, src,
                                                     lens, BOS, EOS, **kw)
    assert c_ids.shape == f_ids.shape
    np.testing.assert_array_equal(c_ids, f_ids)
    np.testing.assert_allclose(c_sc, f_sc, rtol=1e-4, atol=1e-5)


def test_port_second_translate_equals_fresh_executor():
    """The state enc_main, cache_startup and the reorder program write
    is what the step reads: a second translate of another source batch
    through one executor equals a fresh executor's bit for bit, a second
    beam translate equals the first, and neither adds a key."""
    exe, scope, _, _, programs = _port_only(batch=6, seed=19)
    src_a, lens_a = _source(6, seed=11)
    src_b, lens_b = _source(6, seed=12)
    beam_src, beam_lens = _source(2, seed=13)
    with ptt.scope_guard(scope):
        port_tfm.greedy_translate_cached(exe, programs, src_a, lens_a, BOS,
                                         EOS)
        beam = port_tfm.beam_translate_cached(exe, programs, beam_src,
                                              beam_lens, BOS, EOS,
                                              beam_size=3)
        compiled = exe.compile_count  # an entry a key on the CPU
        again = port_tfm.greedy_translate_cached(exe, programs, src_b,
                                                 lens_b, BOS, EOS)
        beam_again = port_tfm.beam_translate_cached(exe, programs, beam_src,
                                                    beam_lens, BOS, EOS,
                                                    beam_size=3)
        assert exe.compile_count == compiled  # the same keys, reorder too
        fresh_exe = ptt.Executor(ptt.CPUPlace())
        fresh_exe.run(programs[2])
        fresh = port_tfm.greedy_translate_cached(fresh_exe, programs, src_b,
                                                 lens_b, BOS, EOS)
    np.testing.assert_array_equal(again, fresh)
    for a, b in zip(beam_again, beam):
        np.testing.assert_array_equal(a, b)
    enc = scope.find_var("tfm_enc_out_cache")
    assert torch.is_tensor(enc) and tuple(enc.shape) == (6, TS, 32)


def test_translate_step_reaches_the_attention_kernels(monkeypatch):
    """The one-token step: self-attention at Tq 1 with the <=pos key
    bias and cross-attention at Tq 1 with the source-padding bias (B3's
    key-bias form, B3d's rows); the W-wide step: self-attention through
    flash_attention_piece (B9) and cross-attention at Tq W over Ts keys,
    not causal, with the key bias (B3's tile forward at Tq != Tk)."""
    from paddle_tpu_torch.ops import nn_ops

    seen = []
    real_flash, real_piece = nn_ops.flash_attention, nn_ops.flash_attention_piece

    def flash(q, k, v, kbias, causal, scale, window, seg):
        seen.append(("flash", tuple(q.shape), tuple(k.shape),
                     tuple(kbias.shape), causal))
        return real_flash(q, k, v, kbias, causal, scale, window, seg)

    def piece(q, k, v, causal, scale, qoff, window):
        assert torch.is_tensor(qoff) and qoff.numel() == 1
        seen.append(("piece", tuple(q.shape), tuple(k.shape), causal))
        return real_piece(q, k, v, causal, scale, qoff, window)

    monkeypatch.setattr(nn_ops, "flash_attention", flash)
    monkeypatch.setattr(nn_ops, "flash_attention_piece", piece)
    _, port_hp = _configs(False)
    src, lens = _source(2)
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        _, start, _, _ = port_tfm.transformer_logits_program(
            port_hp, src_len=TS, trg_len=TT)
        exe.run(start)
        progs = [port_tfm.transformer_decode_programs(
            port_hp, batch=2, src_len=TS, t_max=TT, width=w) for w in (1, 4)]
        for w, (enc, step, zero, _, _, _, fetch) in zip((1, 4), progs):
            exe.run(zero)
            exe.run(enc, feed={"src_word": src,
                               "src_slf_attn_bias": port_tfm.pad_bias(
                                   lens, TS)}, fetch_list=[])
            seen.clear()  # the encoder's own attention
            feed = {"trg_tok": src[:, :w], "pos": np.array([3])}
            if w > 1:
                feed["pos_vec"] = np.arange(3, 3 + w)
            (lg,) = exe.run(step, feed=feed, fetch_list=fetch)
            assert np.isfinite(lg).all()
            self_form = (("flash", (4, 1, 16), (4, TT, 16), (4, TT), False)
                         if w == 1 else
                         ("piece", (4, 4, 16), (4, TT, 16), True))
            cross = ("flash", (4, w, 16), (4, TS, 16), (4, TS), False)
            assert seen == [self_form, cross] * 2
