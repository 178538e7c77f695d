"""paddle_tpu_torch serving engine against the reference engine on the
CPU: the same weights (carried with io.params_from_numpy from a seeded
reference scope) and the same churn trace (more requests than slots,
staggered arrivals, greedy and sampled) through both engines, in
lockstep.

- the ragged step's feeds are equal and its logits match at every step
  (rtol 1e-4, atol 1e-5: the two frameworks' CPU matmuls sum in
  different orders, and the error grows over the layers);
- the tokens the port picks equal the reference's wherever the
  reference's top-2 logit margin exceeds 1e-3 (below that, rounding may
  flip a near-tie; the port is then fed the reference's token so the
  two runs stay in lockstep);
- the port's pooled run equals its own run_solo bit for bit;
- no paddle_tpu_torch module pulls jax or paddle_tpu into a process."""

import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu.models import gpt2 as ref_gpt2
from paddle_tpu.serving import Request as RefRequest
from paddle_tpu.serving import ServingEngine as RefEngine
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.serving import Request, ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


_HP = dict(vocab_size=61, n_ctx=32, d_model=64, n_layer=2, n_head=4,
           dropout=0.0)
RefHP = type("RefHP", (ref_gpt2.GPT2Config,), _HP)
PortHP = type("PortHP", (port_gpt2.GPT2Config,), _HP)
ENGINE = dict(n_slots=4, width=4, t_max=24)


def _churn(request_cls, seed=0):
    """8 requests > 4 slots, staggered arrivals, mixed lengths, half
    greedy and half sampled (per-request temperature / top-k / top-p)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(8):
        sampled = i % 2 == 1
        reqs.append(request_cls(
            rid=i, prompt=rng.randint(1, 61, int(rng.randint(2, 11))),
            max_new_tokens=int(rng.randint(3, 9)),
            temperature=0.8 + 0.1 * (i % 3) if sampled else 1.0,
            top_k=[0, 8, 16][i % 3] if sampled else 0,
            top_p=0.9 if sampled and i % 4 == 1 else 1.0,
            seed=1000 + i if sampled else None, arrival=float(i) * 0.9))
    return reqs


class _Recorder:
    """Wrap an executor's run: record (feed, logits) of every step."""

    def __init__(self, exe, step_main):
        self.steps = []
        run = exe.run

        def recording_run(program=None, feed=None, fetch_list=None, **kw):
            out = run(program, feed=feed, fetch_list=fetch_list, **kw)
            if program is step_main:
                self.steps.append(({k: np.array(v) for k, v in feed.items()},
                                   np.asarray(out[0])))
            return out

        exe.run = recording_run


def _lockstep(engine, trace, ref_hp=RefHP, port_hp=PortHP):
    """The reference engine run over a seeded scope, and the port engine
    over the same weights, each driven through `trace(request_cls)`; the
    port engine is held in lockstep to the reference's tokens."""
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()), \
            pfluid.scope_guard(pfluid.Scope()):
        _, ref_start, _, _ = ref_gpt2.gpt2_logits_program(ref_hp, seq_len=24)
        ref_start.random_seed = 7
        ref_exe = pfluid.Executor(pfluid.CPUPlace())
        ref_exe.run(ref_start)
        scope = pfluid.global_scope()
        weights = {n: np.asarray(scope.find_var(n))
                   for n in scope.local_var_names()}
        ref_eng = RefEngine(ref_exe, ref_hp, **engine)
        ref_rec = _Recorder(ref_exe, ref_eng.step_main)
        ref_picks = []
        pick = ref_eng._pick_tokens

        def ref_pick(rows, slots, draft_rows=None):
            out = pick(rows, slots, draft_rows)
            ref_picks.append((np.array(rows), out.copy()))
            return out

        ref_eng._pick_tokens = ref_pick
        ref_results, _ = ref_eng.run(trace(RefRequest))

    port_scope = ptt.Scope()
    params_from_numpy(weights, port_scope, ptt.CPUPlace())
    with ptt.scope_guard(port_scope):
        port_exe = ptt.Executor(ptt.CPUPlace())
        port_eng = ServingEngine(port_exe, port_hp, **engine)
        port_rec = _Recorder(port_exe, port_eng.step_main)
        port_picks = []
        own_pick = port_eng._pick_tokens

        def lockstep_pick(rows, slots, draft_rows=None):
            mine = own_pick(rows, slots, draft_rows)
            port_picks.append(mine.copy())
            return ref_picks[len(port_picks) - 1][1].copy()

        port_eng._pick_tokens = lockstep_pick
        port_results, port_stats = port_eng.run(trace(Request))
        port_eng._pick_tokens = own_pick
    return dict(ref_rec=ref_rec, port_rec=port_rec, ref_picks=ref_picks,
                port_picks=port_picks, ref_results=ref_results,
                port_results=port_results, port_stats=port_stats,
                port_eng=port_eng, port_scope=port_scope)


@pytest.fixture(scope="module")
def engines():
    """Both engines through the churn trace, in lockstep."""
    return _lockstep(ENGINE, _churn)


def _assert_same_steps(engines, min_steps):
    ref, port = engines["ref_rec"].steps, engines["port_rec"].steps
    assert len(port) == len(ref) > min_steps
    for i, ((rf, rl), (pf, pl)) in enumerate(zip(ref, port)):
        assert sorted(pf) == sorted(rf)
        for k in rf:
            np.testing.assert_array_equal(pf[k], rf[k].astype(pf[k].dtype),
                                          err_msg="step %d feed %s" % (i, k))
        np.testing.assert_allclose(pl, rl, rtol=1e-4, atol=1e-5,
                                   err_msg="step %d logits" % i)


def test_feeds_and_logits_match_reference_every_step(engines):
    _assert_same_steps(engines, 8)


def test_one_slot_engine_matches_reference(monkeypatch):
    """A pool of one slot (a one-row QStart) serves a short mixed trace:
    feeds and logits match the reference at every step, every request
    finishes OK, and the attention goes through the qvec kernel's
    wrapper, as it must to run on the card."""
    from paddle_tpu_torch.ops import nn_ops

    calls = []
    real = nn_ops.flash_attention_qvec

    def spy(*args):
        if args[0].device.type != "meta":  # not build-time shape inference
            calls.append(1)
        return real(*args)

    monkeypatch.setattr(nn_ops, "flash_attention_qvec", spy)
    eng = _lockstep(dict(n_slots=1, width=4, t_max=24),
                    lambda cls: _churn(cls)[:3])
    _assert_same_steps(eng, 3)
    assert len(calls) == len(eng["port_rec"].steps) * PortHP.n_layer
    assert sorted(eng["port_results"]) == [0, 1, 2]
    for rid, r in eng["ref_results"].items():
        p = eng["port_results"][rid]
        assert p["status"] == r["status"] == "OK"
        np.testing.assert_array_equal(p["tokens"], r["tokens"])


def test_tokens_match_reference_where_margin_is_clear(engines):
    checked = 0
    for (rows, ref_tok), port_tok in zip(engines["ref_picks"],
                                         engines["port_picks"]):
        top2 = np.sort(rows, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-3
        np.testing.assert_array_equal(port_tok[clear], ref_tok[clear])
        checked += int(clear.sum())
    assert checked >= 30
    for rid, r in engines["ref_results"].items():
        p = engines["port_results"][rid]
        assert p["status"] == r["status"] == "OK"
        np.testing.assert_array_equal(p["tokens"], r["tokens"])


def test_port_pooled_equals_run_solo(engines):
    """The pooled run (here held to the reference's tokens) is replayed
    with the port's own picks, and every request equals its run_solo
    through the same engine, greedy and sampled."""
    eng = engines["port_eng"]
    with ptt.scope_guard(engines["port_scope"]):
        pooled, stats = eng.run(_churn(Request))
        assert stats["admitted"] == 8 and stats["finished"] == 8
        plans = eng.exe.compile_count
        for req in _churn(Request):
            solo, _ = eng.run_solo(req)
            np.testing.assert_array_equal(pooled[req.rid]["tokens"], solo)
            assert pooled[req.rid]["tokens"].size == req.max_new_tokens
        assert eng.exe.compile_count == plans  # churn never re-plans


def test_admission_control_matches_reference():
    """A bounded wait queue and per-request deadlines: both engines reject
    and expire the same requests at the same steps, and emit the same
    number of tokens for every request (greedy, no EOS, so the counts do
    not depend on the token values)."""

    def burst(request_cls):
        rng = np.random.RandomState(4)
        # (arrival, max_new_tokens, deadline); 2 slots, queue_depth 1:
        # rids 0-3 arrive together, two are admitted, rid 2 waits and
        # rid 3 is rejected; rid 1 expires mid-decode, rid 4 while queued
        spec = [(0.0, 6, None), (0.0, 9, 4), (0.0, 3, None), (0.0, 3, None),
                (5.0, 4, 1), (6.0, 5, None)]
        return [request_cls(rid=i, prompt=rng.randint(1, 61, 5),
                            max_new_tokens=n, arrival=a, deadline=d)
                for i, (a, n, d) in enumerate(spec)]

    engine = dict(n_slots=2, width=4, t_max=24, queue_depth=1)
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()), \
            pfluid.scope_guard(pfluid.Scope()):
        _, ref_start, _, _ = ref_gpt2.gpt2_logits_program(RefHP, seq_len=24)
        ref_start.random_seed = 11
        ref_exe = pfluid.Executor(pfluid.CPUPlace())
        ref_exe.run(ref_start)
        scope = pfluid.global_scope()
        weights = {n: np.asarray(scope.find_var(n))
                   for n in scope.local_var_names()}
        ref, ref_stats = RefEngine(ref_exe, RefHP, **engine).run(
            burst(RefRequest))
    port_scope = ptt.Scope()
    params_from_numpy(weights, port_scope, ptt.CPUPlace())
    with ptt.scope_guard(port_scope):
        port, port_stats = ServingEngine(
            ptt.Executor(ptt.CPUPlace()), PortHP, **engine).run(
                burst(Request))
    assert sorted(port) == sorted(ref) == list(range(6))
    statuses = {rid: r["status"] for rid, r in port.items()}
    assert statuses == {rid: r["status"] for rid, r in ref.items()}
    assert statuses[3] == "REJECTED_QUEUE_FULL"
    assert statuses[1] == statuses[4] == "DEADLINE_EXPIRED"
    for rid, r in ref.items():
        p = port[rid]
        assert p["tokens"].size == r["tokens"].size, rid
        assert (p["admit_step"], p["finish_step"]) == (
            r["admit_step"], r["finish_step"]), rid
    for key in ("steps", "admitted", "finished", "rejected", "expired",
                "new_tokens"):
        assert port_stats[key] == ref_stats[key], key


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
bad = [n for n in sys.modules
       if n == "jax" or n.startswith("jax.") or n == "paddle_tpu"
       or n.startswith("paddle_tpu.")]
assert not bad, bad
for n in ("paddle_tpu_torch.serving.prefix", "paddle_tpu_torch.serving.engine",
          "paddle_tpu_torch.models.decode_cache",
          "paddle_tpu_torch.serving.router",
          "paddle_tpu_torch.distributed.faults"):
    assert n in sys.modules, n
print("OK", len([n for n in sys.modules if n.startswith("paddle_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
