"""Speculative decoding in paddle_tpu_torch against the reference on the
CPU: a narrow GPT-2 (vocab 61, n_ctx 32, d_model 64, 2 layers, 4 heads)
and two drafts, its one-layer truncation and a copy of the whole model,
each in a scope of its own, weights carried by name from a seeded
reference scope (io.params_from_numpy).

- the resolver's keyed rule (decode_cache.greedy_accept_len,
  residual_probs, spec_key, spec_propose_keyed, spec_accept_keyed,
  spec_token_keyed) bit-equal to the reference's on seeded inputs;
- speculative_generate_cached and speculative_sample_generate_cached in
  lockstep with the reference's: every prefill, draft step and verify
  round's logits within rtol 1e-4, atol 1e-5, and the port's own token
  decisions equal the reference's wherever the top-2 logit margin
  exceeds 1e-3 (the port is fed the reference's decision, so the runs
  stay in lockstep); free-running, the same tokens and stats;
- the speculative serving engine (draft "self", and a one-layer draft in
  its own scope) against the reference engine on the churn trace: feeds,
  target and draft logits at every step, the counters;
- the port's own contracts: speculative greedy == greedy, pooled ==
  run_solo, greedy spec engine == the plain engine, the self draft's
  acceptance 1.0 on sampled requests."""

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu.models import decode_cache as ref_dc
from paddle_tpu.models import gpt2 as ref_gpt2
from paddle_tpu.serving import Request as RefRequest
from paddle_tpu.serving import ServingEngine as RefEngine
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import decode_cache as port_dc
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.serving import Request, ServingEngine

from test_torch_serving import _HP, ENGINE, _churn, _Recorder

T_MAX, SPEC_K = 24, 4
RefHP = type("RefHP", (ref_gpt2.GPT2Config,), _HP)
PortHP = type("PortHP", (port_gpt2.GPT2Config,), _HP)
RefDraft = type("RefDraft", (RefHP,), dict(n_layer=1))
PortDraft = type("PortDraft", (PortHP,), dict(n_layer=1))


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


def _reference_weights(seed=7):
    """The narrow GPT-2's weights from a seeded reference startup."""
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()), \
            pfluid.scope_guard(pfluid.Scope()):
        _, start, _, _ = ref_gpt2.gpt2_logits_program(RefHP, seq_len=T_MAX)
        start.random_seed = seed
        pfluid.Executor(pfluid.CPUPlace()).run(start)
        scope = pfluid.global_scope()
        return {n: np.asarray(scope.find_var(n))
                for n in scope.local_var_names()}


def _draft_names(gpt2, draft_hp):
    """The parameter names of `draft_hp`'s logits program (those of the
    target's first blocks: gpt2_logits_program names both alike)."""
    with gpt2_guard(gpt2):
        main, _, _, _ = gpt2.gpt2_logits_program(draft_hp, seq_len=T_MAX)
    return [p.name for p in main.global_block().all_parameters()]


def gpt2_guard(gpt2):
    fluid = pfluid if gpt2 is ref_gpt2 else ptt
    return fluid.program_guard(fluid.Program(), fluid.Program())


# ---------------------------------------------------------------------------
# the keyed rule
# ---------------------------------------------------------------------------
def _probs(rng, n, v, zero=False):
    p = rng.rand(n, v) ** 3
    if zero:
        p[:, : v // 2] = 0.0
    return p / p.sum(-1, keepdims=True)


def _helper_cases(name):
    """40 argument tuples for helper `name`, seeded numpy inputs (some
    degenerate: equal rows, zeroed halves)."""
    rng = np.random.RandomState(["greedy_accept_len", "residual_probs",
                                 "spec_key", "spec_propose_keyed",
                                 "spec_accept_keyed",
                                 "spec_token_keyed"].index(name))
    v = 61
    cases = []
    for i in range(40):
        seed, step = int(rng.randint(0, 2 ** 31)), int(rng.randint(0, 5000))
        if name == "greedy_accept_len":
            tgt = rng.randint(0, 4, (3, 5)).astype("int64")
            drafts = [np.where(rng.rand(3) < 0.8, tgt[:, j],
                               rng.randint(0, 4, 3)).astype("int64")
                      for j in range(int(rng.randint(0, 5)))]
            cases.append((tgt, drafts))
        elif name == "residual_probs":
            pt = _probs(rng, 4, v)
            pd = pt.copy() if i % 5 == 0 else _probs(rng, 4, v, i % 2 == 0)
            cases.append((pt, pd))
        elif name == "spec_key":
            cases.append((seed, [0x5D01, 0x5D02, 0x5D03][i % 3], step))
        elif name == "spec_propose_keyed":
            cases.append((_probs(rng, 1, v, i % 2 == 0)[0], seed, step))
        elif name == "spec_accept_keyed":
            pt, pd = _probs(rng, 1, v)[0], _probs(rng, 1, v, i % 3 == 0)[0]
            d = int(rng.choice(v, p=pd))
            cases.append((d, pt, pd, seed, step))
        else:
            cases.append((_probs(rng, 1, v)[0],
                          _probs(rng, 1, v, i % 2 == 0)[0], seed, step))
    return cases


@pytest.mark.parametrize("name", [
    "greedy_accept_len", "residual_probs", "spec_key", "spec_propose_keyed",
    "spec_accept_keyed", "spec_token_keyed"])
def test_keyed_helpers_bit_equal_to_reference(name):
    outcomes = set()
    for args in _helper_cases(name):
        want = getattr(ref_dc, name)(*args)
        got = getattr(port_dc, name)(*args)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()
        else:
            assert type(got) is type(want) and got == want, (args, got, want)
            outcomes.add(str(want)[:40])
    if name in ("greedy_accept_len", "spec_accept_keyed"):
        assert len(outcomes) > 2  # the cases reach several outcomes


# ---------------------------------------------------------------------------
# the solo loops
# ---------------------------------------------------------------------------
def _recording_core(module, log, lockstep=None):
    """module._speculative_core with its three token rules wrapped: each
    call appends (kind, input logits, the rule's own output) to `log`;
    with `lockstep` (the reference's log), each returns the reference's
    output at the same call instead."""
    real = module._speculative_core

    def core(*args):
        *head, target_pick, draft_pick, resolve = args
        calls = iter(lockstep or ())

        def wrap(kind, fn):
            def rule(*a):
                mine = fn(*a)
                log.append((kind, np.array(a[0]), mine))
                if lockstep is None:
                    return mine
                ref_kind, _, ref_out = next(calls)
                assert ref_kind == kind, (ref_kind, kind)
                return ref_out
            return rule

        return real(*head, wrap("target", target_pick),
                    wrap("draft", draft_pick), wrap("round", resolve))

    return core


def _same_decision(kind, mine, ref):
    if kind == "round":
        acc_m, cur_m, j_m = mine
        acc_r, cur_r, j_r = ref
        return (j_m == j_r and np.array_equal(cur_m, cur_r)
                and all(np.array_equal(a, b) for a, b in zip(acc_m, acc_r)))
    tok_m = mine[0] if kind == "draft" else mine
    tok_r = ref[0] if kind == "draft" else ref
    return np.array_equal(tok_m, tok_r)


def _margin(logits):
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _solo_programs(gpt2, hp, draft_hp):
    """Target step / wide programs and the draft's step program (batch
    2), each built under a fresh guard."""
    with gpt2_guard(gpt2):
        step = gpt2.gpt2_decode_step_program(hp, batch=2, t_max=T_MAX)
        wide = gpt2.gpt2_decode_step_program(hp, batch=2, t_max=T_MAX,
                                             width=SPEC_K)
        dstep = gpt2.gpt2_decode_step_program(draft_hp, batch=2, t_max=T_MAX)
    return step, wide, dstep


def _solo_call(gpt2, exe, progs, draft_scope, prompt, new, sampled):
    step, wide, dstep = progs
    args = (exe, step[0], step[1], step[3], wide[0], wide[3], SPEC_K,
            dstep[0], dstep[1], dstep[3], prompt, new)
    if sampled:
        return gpt2.speculative_sample_generate_cached(
            *args, temperature=0.8, top_k=16, top_p=0.9, seed=3,
            draft_scope=draft_scope)
    return gpt2.speculative_generate_cached(*args, draft_scope=draft_scope)


PROMPT = np.random.RandomState(6).randint(1, 61, (2, 5)).astype("int64")
NEW = 14


def _reference_solo(monkeypatch, weights, draft, sampled):
    ref_hp = RefDraft if draft == "small" else RefHP
    log = []
    monkeypatch.setattr(ref_gpt2, "_speculative_core",
                        _recording_core(ref_gpt2, log))
    with pfluid.scope_guard(pfluid.Scope()):
        scope = pfluid.global_scope()
        for n, w in weights.items():
            scope.set(n, w)
        dscope = pfluid.Scope()
        for n in _draft_names(ref_gpt2, ref_hp):
            dscope.set(n, weights[n])
        progs = _solo_programs(ref_gpt2, RefHP, ref_hp)
        exe = pfluid.Executor(pfluid.CPUPlace())
        tokens, stats = _solo_call(ref_gpt2, exe, progs, dscope, PROMPT,
                                   NEW, sampled)
    monkeypatch.undo()
    return log, tokens, stats


def _port_solo(weights, draft, sampled, lockstep=None, monkeypatch=None):
    port_hp = PortDraft if draft == "small" else PortHP
    log = []
    if lockstep is not None:
        monkeypatch.setattr(port_gpt2, "_speculative_core",
                            _recording_core(port_gpt2, log, lockstep))
    scope, dscope = ptt.Scope(), ptt.Scope()
    params_from_numpy(weights, scope, ptt.CPUPlace())
    names = _draft_names(port_gpt2, port_hp)
    params_from_numpy({n: weights[n] for n in names}, dscope, ptt.CPUPlace())
    with ptt.scope_guard(scope):
        progs = _solo_programs(port_gpt2, PortHP, port_hp)
        exe = ptt.Executor(ptt.CPUPlace())
        tokens, stats = _solo_call(port_gpt2, exe, progs, dscope, PROMPT,
                                   NEW, sampled)
    if monkeypatch is not None:
        monkeypatch.undo()
    return log, tokens, stats


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("draft", ["small", "copy"])
def test_speculative_loops_match_reference(monkeypatch, draft, sampled):
    weights = _reference_weights()
    ref_log, ref_tokens, ref_stats = _reference_solo(monkeypatch, weights,
                                                     draft, sampled)
    log, _, _ = _port_solo(weights, draft, sampled, ref_log, monkeypatch)
    assert [k for k, _, _ in log] == [k for k, _, _ in ref_log]
    assert {k for k, _, _ in log} >= {"target", "draft", "round"}
    checked = 0
    for i, ((kind, lg, mine), (_, ref_lg, ref_out)) in enumerate(
            zip(log, ref_log)):
        np.testing.assert_allclose(lg, ref_lg, rtol=1e-4, atol=1e-5,
                                   err_msg="call %d (%s) logits" % (i, kind))
        if _margin(ref_lg) > 1e-3:
            assert _same_decision(kind, mine, ref_out), (i, kind)
            checked += 1
    assert checked >= len(log) - 2
    # free-running: the same tokens and stats as the reference
    _, tokens, stats = _port_solo(weights, draft, sampled)
    np.testing.assert_array_equal(tokens, ref_tokens)
    assert stats == ref_stats
    if draft == "copy" and not sampled:
        assert stats["accept_rate"] == 1.0, stats
    assert stats["rounds"] < NEW


def test_speculative_greedy_equals_greedy_and_checks():
    """The port's own contract: speculative greedy equals
    greedy_generate_cached for either draft, up to the cache's last slot
    (the capacity tail's one-token steps), and spec_k 1 raises."""
    weights = _reference_weights()
    scope = ptt.Scope()
    params_from_numpy(weights, scope, ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        for draft_hp in (PortDraft, PortHP):
            dscope = ptt.Scope()
            params_from_numpy({n: weights[n] for n in _draft_names(
                port_gpt2, draft_hp)}, dscope, ptt.CPUPlace())
            progs = _solo_programs(port_gpt2, PortHP, draft_hp)
            step = progs[0]
            for new in (NEW, T_MAX + 1 - PROMPT.shape[1]):
                want = port_gpt2.greedy_generate_cached(
                    exe, step[0], step[1], step[3], PROMPT, new)
                got, stats = _solo_call(port_gpt2, exe, progs, dscope,
                                        PROMPT, new, False)
                np.testing.assert_array_equal(got, want)
                assert stats["rounds"] < new
        with pytest.raises(ValueError, match="spec_k"):
            port_gpt2.speculative_generate_cached(
                exe, step[0], step[1], step[3], progs[1][0], progs[1][3], 1,
                progs[2][0], progs[2][1], progs[2][3], PROMPT, 2,
                draft_scope=dscope)


# ---------------------------------------------------------------------------
# the speculative serving engine
# ---------------------------------------------------------------------------
class _Lockstep:
    """Patches an engine's token rules: each call appends the rule's own
    output to `mine`; with `ref` (the reference engine's log), it
    returns the reference's output of the same call instead."""

    RULES = ("_pick_tokens", "_draft_pick", "_resolve_spec_row")

    def __init__(self, eng, ref=None):
        self.log = []
        calls = iter(ref.log) if ref is not None else None
        for rule in self.RULES:
            own = getattr(eng, rule)

            def patched(*args, _own=own, _rule=rule, **kw):
                mine = _own(*args, **kw)
                self.log.append((_rule, args, mine))
                if calls is None:
                    return mine
                ref_rule, _, ref_out = next(calls)
                assert ref_rule == _rule, (ref_rule, _rule)
                return (ref_out.copy() if isinstance(ref_out, np.ndarray)
                        else ref_out)

            setattr(eng, rule, patched)


def _spec_engines(draft, engine=ENGINE, trace=_churn, prefix=None):
    """The reference and the port engines over the same weights, the
    port's in lockstep with the reference's: speculative with draft
    "self" or "separate" (a one-layer draft in its own scope), plain with
    None; `prefix` (templates) registers them on engines built with
    prefix_rows."""
    weights = _reference_weights()
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()), \
            pfluid.scope_guard(pfluid.Scope()):
        scope = pfluid.global_scope()
        for n, w in weights.items():
            scope.set(n, w)
        ref_exe = pfluid.Executor(pfluid.CPUPlace())
        kw = dict(engine, spec_k=3) if draft else dict(engine)
        if draft == "self":
            kw["draft"] = "self"
        elif draft:
            dscope = pfluid.Scope()
            for n in _draft_names(ref_gpt2, RefDraft):
                dscope.set(n, weights[n])
            kw["draft"] = (RefDraft, dscope)
        ref_eng = RefEngine(ref_exe, RefHP, **kw)
        ref_rec = _Recorder(ref_exe, ref_eng.step_main)
        ref_draft = _Recorder(ref_exe, getattr(ref_eng, "draft_main", None))
        for p in prefix or ():
            ref_eng.register_prefix(p)
        ref_rec.steps.clear()
        ref_draft.steps.clear()
        ref_rules = _Lockstep(ref_eng)
        ref_results, ref_stats = ref_eng.run(trace(RefRequest))

    port_scope = ptt.Scope()
    params_from_numpy(weights, port_scope, ptt.CPUPlace())
    with ptt.scope_guard(port_scope):
        port_exe = ptt.Executor(ptt.CPUPlace())
        kw = dict(engine, spec_k=3) if draft else dict(engine)
        if draft == "self":
            kw["draft"] = "self"
        elif draft:
            dscope = ptt.Scope()
            params_from_numpy({n: weights[n] for n in _draft_names(
                port_gpt2, PortDraft)}, dscope, ptt.CPUPlace())
            kw["draft"] = (PortDraft, dscope)
        port_eng = ServingEngine(port_exe, PortHP, **kw)
        port_rec = _Recorder(port_exe, port_eng.step_main)
        port_draft = _Recorder(port_exe, getattr(port_eng, "draft_main",
                                                  None))
        for p in prefix or ():
            port_eng.register_prefix(p)
        port_rec.steps.clear()
        port_draft.steps.clear()
        own = {r: getattr(port_eng, r) for r in _Lockstep.RULES}
        port_rules = _Lockstep(port_eng, ref_rules)
        port_results, port_stats = port_eng.run(trace(Request))
        for r, fn in own.items():
            setattr(port_eng, r, fn)
    return dict(ref_rec=ref_rec, ref_draft=ref_draft, ref_rules=ref_rules,
                ref_results=ref_results, ref_stats=ref_stats,
                port_rec=port_rec, port_draft=port_draft,
                port_rules=port_rules, port_results=port_results,
                port_stats=port_stats, port_eng=port_eng,
                port_scope=port_scope, weights=weights)


@pytest.fixture(scope="module", params=["self", "separate"])
def spec(request):
    return _spec_engines(request.param)


def _assert_same_dispatches(ref_steps, port_steps, what, min_steps):
    assert len(port_steps) == len(ref_steps) > min_steps, what
    for i, ((rf, rl), (pf, pl)) in enumerate(zip(ref_steps, port_steps)):
        assert sorted(pf) == sorted(rf)
        for k in rf:
            np.testing.assert_array_equal(
                pf[k], rf[k].astype(pf[k].dtype),
                err_msg="%s %d feed %s" % (what, i, k))
        np.testing.assert_allclose(pl, rl, rtol=1e-4, atol=1e-5,
                                   err_msg="%s %d logits" % (what, i))


def test_spec_engine_feeds_and_logits_match_reference(spec):
    _assert_same_dispatches(spec["ref_rec"].steps, spec["port_rec"].steps,
                            "target step", 6)
    _assert_same_dispatches(spec["ref_draft"].steps,
                            spec["port_draft"].steps, "draft step", 8)


def test_spec_engine_decisions_and_counters_match_reference(spec):
    ref, port = spec["ref_rules"].log, spec["port_rules"].log
    assert [r for r, _, _ in port] == [r for r, _, _ in ref]
    assert {r for r, _, _ in ref} == set(_Lockstep.RULES)
    for i, ((rule, args, mine), (_, ref_args, want)) in enumerate(
            zip(port, ref)):
        if rule == "_resolve_spec_row":
            assert tuple(mine) == tuple(want), i
        else:
            np.testing.assert_array_equal(np.asarray(mine),
                                          np.asarray(want), err_msg=str(i))
    for key in ("steps", "admitted", "finished", "new_tokens",
                "prefill_chunks", "spec_rounds", "spec_proposed",
                "spec_accepted", "draft_steps"):
        assert spec["port_stats"][key] == spec["ref_stats"][key], key
    assert spec["port_stats"]["spec_rounds"] > 5
    assert spec["port_stats"]["accept_rate"] == spec["ref_stats"][
        "accept_rate"]
    for rid, r in spec["ref_results"].items():
        p = spec["port_results"][rid]
        assert p["status"] == r["status"] == "OK"
        np.testing.assert_array_equal(p["tokens"], r["tokens"])
        for key in ("spec_proposed", "spec_accepted", "accept_rate",
                    "prefix_len"):
            assert p[key] == r[key], (rid, key)


def test_spec_engine_pooled_equals_solo_and_plain(spec):
    """The port's own picks: every request equals its run_solo, greedy
    requests equal the plain engine's, the self draft accepts every
    proposal, and the churn never re-plans."""
    eng = spec["port_eng"]
    with ptt.scope_guard(spec["port_scope"]):
        pooled, stats = eng.run(_churn(Request))
        plans = eng.exe.compile_count
        for req in _churn(Request):
            solo, _ = eng.run_solo(req)
            np.testing.assert_array_equal(pooled[req.rid]["tokens"], solo)
            assert pooled[req.rid]["tokens"].size == req.max_new_tokens
        assert eng.exe.compile_count == plans
        plain = ServingEngine(eng.exe, PortHP, **ENGINE)
        want, _ = plain.run(_churn(Request))
    for req in _churn(Request):
        if req.greedy:
            np.testing.assert_array_equal(pooled[req.rid]["tokens"],
                                          want[req.rid]["tokens"])
    s = eng.stats()
    assert s["spec_on"] and s["spec_k"] == 3
    assert stats["spec_rounds"] > 5
    if eng.draft_scope is None:
        # a self draft's rows equal the target's columns while its cache
        # holds the same history: a sampled round has no bonus, so that
        # lasts (a greedy round accepting every proposal emits its bonus
        # without writing the last draft's K/V to the draft's cache, as
        # the reference's round does)
        for req in _churn(Request):
            if not req.greedy:
                assert pooled[req.rid]["accept_rate"] == 1.0, req.rid
