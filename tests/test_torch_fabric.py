"""paddle_tpu_torch's serving fabric (serving/router.py) and its fault
schedule (distributed/faults.py) against the reference on the CPU.

Against the reference, same inputs from a seed:
- FaultSchedule: the action sequence and delay_fraction of seeded
  schedules, draw for draw, and the validation errors;
- parse_pool_schedule, Request.to_wire / from_wire and
  ServingEngine.wire_result;
- the router itself: three pools of a tiny GPT-2 (the weights of one
  seeded reference startup, carried with io.params_from_numpy) on the
  reference's 14-request chaos trace, with a pinned pool kill, with no
  fault and with a seeded bare pool kill.  Greedy and sampled, eos_id
  unset, so the fabric's schedule does not depend on token values: every
  result's pool, status and steps, the counters and stats() (minus the
  wall clock) equal the reference's.  The port is fed the reference's
  tokens (lockstep) and its own picks equal them wherever the
  reference's top-2 logit margin exceeds 1e-3.

The reference's in-process contracts, held on the port (its streams
against its own run_solo, bit for bit): multi-pool exactness, a
one-pool fabric equal to engine.run, submit-time rejections, pool-kill
failover with replay tails equal to solo runs and no new compile on
survivors, the seeded victim pick, a dead step thread, scale 1 -> 3 ->
1, drain-and-retire, backpressure, deadlines, cross-pool placement,
prefix-aware placement and a speculative pool's stats.

Port-only: the process-pool members raise naming ROADMAP A5.4b; a
device error inside a pool's step propagates out of step() (no
failover hides the device) while an AttributeError still fails over;
a gone pool's executor is closed and its compile_count still reads."""

import ast
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu.distributed.faults import FaultSchedule as RefFaultSchedule
from paddle_tpu.models import gpt2 as ref_gpt2
from paddle_tpu.serving import FabricRouter as RefRouter
from paddle_tpu.serving import Request as RefRequest
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import make_poisson_trace as ref_trace
from paddle_tpu.serving import parse_pool_schedule as ref_parse
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.distributed.faults import FaultSchedule
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.models import gpt2 as port_gpt2
from paddle_tpu_torch.serving import (FabricRouter, Request, ServingEngine,
                                      make_poisson_trace, parse_pool_schedule)
from paddle_tpu_torch.serving import router as router_mod


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
T_MAX = 24


@pytest.fixture(scope="module")
def weights():
    """The tiny GPT-2's weights from one seeded reference startup."""
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()), \
            pfluid.scope_guard(pfluid.Scope()):
        _, start, _, _ = ref_gpt2.gpt2_logits_program(RefHP, seq_len=T_MAX)
        start.random_seed = 7
        pfluid.Executor(pfluid.CPUPlace()).run(start)
        scope = pfluid.global_scope()
        return {n: np.asarray(scope.find_var(n))
                for n in scope.local_var_names()}


def _pool_factory(weights, hp=PortHP, n_slots=2, width=4, t_max=T_MAX,
                  engines=None, **engine_kw):
    """Factory building one port pool: `weights` in a FRESH scope (every
    pool holds identical weights, the failover-replay precondition).
    `engines` collects every engine built, retired ones included; each
    engine counts its executor's runs per program (`_runs`)."""

    def factory():
        scope = ptt.Scope()
        params_from_numpy(weights, scope, ptt.CPUPlace())
        with ptt.scope_guard(scope):
            exe = ptt.Executor(ptt.CPUPlace())
            eng = ServingEngine(exe, hp, n_slots=n_slots, width=width,
                                t_max=t_max, **engine_kw)
        eng._runs = {}
        run = exe.run

        def counted(program=None, feed=None, fetch_list=None, **kw):
            eng._runs[id(program)] = eng._runs.get(id(program), 0) + 1
            return run(program, feed=feed, fetch_list=fetch_list, **kw)

        exe.run = counted
        if engines is not None:
            engines.append(eng)
        return eng, scope

    return factory


def _trace(n, rate, seed, out_hi=10, cls=make_poisson_trace):
    return cls(n, rate=rate, prompt_len_range=(2, 8),
               out_len_range=(4, out_hi), vocab_size=_HP["vocab_size"],
               seed=seed)


def _assert_solo_exact(weights, results, trace_args, **engine_kw):
    """Every OK stream must be BIT-identical to its solo run on a fresh
    pool holding the same weights."""
    eng, scope = _pool_factory(weights, n_slots=4, **engine_kw)()
    checked = 0
    with ptt.scope_guard(scope):
        for r in _trace(*trace_args):
            if results[r.rid]["status"] != "OK":
                continue
            ref, _ = eng.run_solo(r)
            got = np.asarray(results[r.rid]["tokens"])
            assert np.array_equal(np.asarray(ref), got), (
                "rid %r diverged from solo" % (r.rid,))
            checked += 1
    assert checked


def _drain(router, limit=3000):
    while router.queue or any(h.engine.queue or h.engine.pool.active_slots()
                              for h in router.pools.values()):
        router.step()
        assert router.now < limit


# ---------------------------------------------------------------------------
# FaultSchedule, parse_pool_schedule and the wire codec vs the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_fault_schedule_matches_reference(seed, rate):
    """Seeded schedules give the reference's actions draw for draw, the
    three directions interleaved (one shared rng), explicit frames first,
    and bit-equal delay fractions."""
    kw = dict(drop=rate / 3, delay=rate / 3, dup=rate / 6,
              truncate=rate / 12, corrupt=rate / 12, pool_kill=rate * 0.6,
              pool_proc_kill=rate * 0.4)
    pinned = {"c2s": {3: "drop"}, "s2c": {5: "corrupt", 7: "pass"},
              "fabric": {4: "pool_kill:2", 9: "pool_proc_kill"}}
    ours, ref = FaultSchedule(pinned, seed=seed, **kw), \
        RefFaultSchedule(pinned, seed=seed, **kw)
    seen = set()
    for i in range(64):
        for direction in ("c2s", "s2c", "fabric"):
            got = ours.next_action(direction)
            assert got == ref.next_action(direction), (i, direction)
            seen.add(got[1])
        assert ours.delay_fraction(i) == ref.delay_fraction(i)
        assert 0.0 < ours.delay_fraction(i) <= 1.0
    assert ("pool_kill" in seen) == (rate > 0)


def test_fault_schedule_seed_from_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SEED", "17")
    ours, ref = FaultSchedule(pool_kill=0.5), RefFaultSchedule(pool_kill=0.5)
    assert [ours.next_action("fabric") for _ in range(32)] == \
        [ref.next_action("fabric") for _ in range(32)]
    assert ours.delay_fraction(3) == ref.delay_fraction(3) \
        == FaultSchedule(seed=17).delay_fraction(3)


@pytest.mark.parametrize("schedule, error", [
    ({"fabric": {3: "pool_kill"}}, None),
    ({"fabric": {3: "pool_kill:2", 5: "pass"}}, None),
    ({"c2s": {3: "pool_kill"}}, "not valid"),
    ({"fabric": {3: "drop"}}, "not valid"),
    ({"fabric": {3: "pool_kill:x"}}, "unknown fault action"),
    ({"sideways": {0: "pass"}}, "direction"),
])
def test_pool_kill_action_validation(schedule, error):
    """The reference's validation cases: a schedule typo fails loudly at
    construction, with the reference's message."""
    if error is None:
        FaultSchedule(schedule)
        RefFaultSchedule(schedule)
        return
    with pytest.raises(ValueError, match=error) as ours:
        FaultSchedule(schedule)
    with pytest.raises(ValueError) as ref:
        RefFaultSchedule(schedule)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("spec", ["4:+2,30:-2", " 9:-1 , 2:+3 ", "5:+2,20:-2",
                                  "", "   ", " , ", None])
def test_parse_pool_schedule_matches_reference(spec):
    assert parse_pool_schedule(spec) == ref_parse(spec)


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_request_wire_codec_matches_reference(kind):
    kw = dict(rid="w1", prompt=np.arange(1, 6), max_new_tokens=4,
              arrival=1.5, deadline=9, sample_step_base=3)
    if kind == "sampled":
        kw.update(temperature=0.9, top_k=8, top_p=0.9, seed=11, eos_id=2)
    ours, ref = Request(**kw).to_wire(), RefRequest(**kw).to_wire()
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if k == "prompt":
            assert ours[k].dtype == v.dtype
            np.testing.assert_array_equal(ours[k], v)
        else:
            assert ours[k] == v and type(ours[k]) is type(v), k
    back = Request.from_wire(ours)
    np.testing.assert_array_equal(back.prompt, kw["prompt"])
    for k in ("rid", "max_new_tokens", "temperature", "top_k", "top_p",
              "seed", "eos_id", "arrival", "deadline", "sample_step_base"):
        assert getattr(back, k) == getattr(Request(**kw), k), k
    assert back.greedy == (kind == "greedy")


def test_wire_result_coerces_like_reference():
    r = {"tokens": [3, 4, 5], "prompt_len": np.int64(5),
         "admit_step": None, "finish_step": np.int32(9), "status": "OK",
         "latency_s": np.float32(0.25), "accept_rate": 1, "replayed": True,
         "spec_accepted": np.int64(2)}
    ours, ref = ServingEngine.wire_result(r), RefEngine.wire_result(r)
    assert sorted(ours) == sorted(ref)
    assert ours["tokens"].dtype == np.int64
    np.testing.assert_array_equal(ours["tokens"], ref["tokens"])
    for k in ref:
        if k != "tokens":
            assert ours[k] == ref[k] and type(ours[k]) is type(ref[k]), k


# ---------------------------------------------------------------------------
# the router in lockstep with the reference's
# ---------------------------------------------------------------------------
_SCENARIOS = {
    "pool_kill_pinned": lambda cls: cls({"fabric": {8: "pool_kill:0"}}),
    "no_fault": lambda cls: None,
    "pool_kill_seeded": lambda cls: cls({"fabric": {6: "pool_kill"}},
                                        seed=11),
}
_CHAOS = (14, 1.2, 4, 12)


def _key(eng, slot):
    s = eng.pool.slots[slot]
    return s.req.rid, len(s.out) + s.req.sample_step_base


def _lockstep_run(weights, scenario):
    """The reference router and the port's over the same weights and
    trace; every pick of the port is replaced by the reference's pick
    of the same (rid, token index)."""
    book = {}  # (rid, index) -> (reference row, reference token)

    def ref_factory():
        scope = pfluid.Scope()
        for n, w in weights.items():
            scope.set(n, jnp.asarray(w))
        with pfluid.scope_guard(scope):
            eng = RefEngine(pfluid.Executor(pfluid.CPUPlace()), RefHP,
                            n_slots=2, width=4, t_max=T_MAX)
        pick = eng._pick_tokens

        def recording(rows, slots, draft_rows=None):
            out = pick(rows, slots, draft_rows)
            for i, slot in enumerate(slots):
                key = _key(eng, slot)
                assert key not in book, key
                book[key] = (np.array(rows[i]), int(out[i]))
            return out

        eng._pick_tokens = recording
        return eng, scope

    ref = RefRouter(ref_factory, n_pools=3, queue_depth=16,
                    fault_schedule=_SCENARIOS[scenario](RefFaultSchedule))
    ref_results, ref_stats = ref.run(_trace(*_CHAOS, cls=ref_trace))

    mine = {}  # (rid, index) -> (own token, own row)
    port_factory = _pool_factory(weights)

    def lockstep_factory():
        eng, scope = port_factory()
        pick = eng._pick_tokens

        def lockstep(rows, slots, draft_rows=None):
            own = pick(rows, slots, draft_rows)
            out = own.copy()
            for i, slot in enumerate(slots):
                key = _key(eng, slot)
                mine[key] = (int(own[i]), np.array(rows[i]))
                out[i] = book[key][1]
            return out

        eng._pick_tokens = lockstep
        return eng, scope

    port = FabricRouter(lockstep_factory, n_pools=3, queue_depth=16,
                        fault_schedule=_SCENARIOS[scenario](FaultSchedule))
    results, stats = port.run(_trace(*_CHAOS))
    return dict(ref_results=ref_results, ref_stats=ref_stats, book=book,
                results=results, stats=stats, mine=mine,
                ref_counters=dict(ref.counters), counters=dict(port.counters))


@pytest.fixture(scope="module")
def lockstep(weights):
    """Each scenario's lockstep runs, made once."""
    made = {}

    def get(scenario):
        if scenario not in made:
            made[scenario] = _lockstep_run(weights, scenario)
        return made[scenario]

    return get


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
def test_fabric_schedule_matches_reference(lockstep, scenario):
    """Placements, statuses, steps, counters and stats() (minus the wall
    clock) equal the reference's; with a kill, failover replayed some."""
    run = lockstep(scenario)
    ref, got = run["ref_results"], run["results"]
    assert sorted(got) == sorted(ref) == list(range(_CHAOS[0]))
    for rid, r in ref.items():
        g = got[rid]
        for k in ("pool", "status", "admit_step", "finish_step",
                  "arrival_step", "prompt_len", "latency_steps"):
            assert g[k] == r[k], (rid, k, g[k], r[k])
        assert g.get("replayed", False) == r.get("replayed", False), rid
        np.testing.assert_array_equal(g["tokens"], r["tokens"])
    assert run["counters"] == run["ref_counters"]
    wall = ("wall_s", "tokens_per_s")
    assert {k: v for k, v in run["stats"].items() if k not in wall} == \
        {k: v for k, v in run["ref_stats"].items() if k not in wall}
    assert (run["stats"]["replaced"] > 0) == (scenario != "no_fault")
    assert run["stats"]["pools_died"] == (scenario != "no_fault")


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
def test_fabric_tokens_match_reference_where_margin_is_clear(lockstep,
                                                             scenario):
    """Every pick was made at the same (rid, token index) in both routers,
    its logits row within rtol 1e-4 / atol 1e-5 of the reference's; the
    port's own greedy pick equals the reference's wherever the
    reference's top-2 margin exceeds 1e-3."""
    run = lockstep(scenario)
    book, mine = run["book"], run["mine"]
    assert sorted(mine) == sorted(book)
    greedy = {r.rid for r in _trace(*_CHAOS) if r.greedy}
    checked = 0
    for key, (ref_row, ref_tok) in book.items():
        own_tok, own_row = mine[key]
        np.testing.assert_allclose(own_row, ref_row, rtol=1e-4, atol=1e-5,
                                   err_msg=str(key))
        top2 = np.sort(ref_row)[-2:]
        if key[0] in greedy and top2[1] - top2[0] > 1e-3:
            assert own_tok == ref_tok, key
            checked += 1
    assert checked >= 30


# ---------------------------------------------------------------------------
# the reference's in-process contracts, on the port
# ---------------------------------------------------------------------------
def test_fabric_multi_pool_exactness(weights):
    router = FabricRouter(_pool_factory(weights), n_pools=3, queue_depth=16)
    args = (12, 0.9, 3)
    results, stats = router.run(_trace(*args))
    assert {r["status"] for r in results.values()} == {"OK"}
    assert stats["finished"] == 12 and stats["rejected"] == 0
    assert stats["replaced"] == 0
    assert all(isinstance(r["pool"], int) for r in results.values())
    assert len({r["pool"] for r in results.values()}) == 3
    _assert_solo_exact(weights, results, args)


def test_fabric_single_pool_matches_engine_run(weights):
    """A one-pool fabric is the engine plus router bookkeeping."""
    router = FabricRouter(_pool_factory(weights, n_slots=4), n_pools=1)
    results, _ = router.run(_trace(10, 0.7, 5))
    eng, scope = _pool_factory(weights, n_slots=4)()
    with ptt.scope_guard(scope):
        ref, _ = eng.run(_trace(10, 0.7, 5))
    assert sorted(ref) == sorted(results)
    for rid, r in ref.items():
        np.testing.assert_array_equal(r["tokens"], results[rid]["tokens"])
        assert (r["admit_step"], r["finish_step"]) == (
            results[rid]["admit_step"], results[rid]["finish_step"])


def test_fabric_duplicate_and_oversized_rejected_at_submit(weights):
    router = FabricRouter(_pool_factory(weights), n_pools=1)
    router.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=3))
    with pytest.raises(ValueError, match="duplicate"):
        router.submit(Request(rid=0, prompt=[3], max_new_tokens=2))
    with pytest.raises(ValueError, match="capacity"):
        router.submit(Request(rid=1, prompt=[1] * T_MAX,
                              max_new_tokens=T_MAX))


def _warm(router):
    """Whether every routed pool has run its step and slot-reset programs
    twice (on the card the second run of a key captures)."""
    return all(h.engine._runs.get(id(h.engine.step_main), 0) >= 2
               and h.engine._runs.get(id(h.engine.reset_prog), 0) >= 2
               for h in router.pools.values())


def test_kill_pool_mid_stream_failover_preserves_solo_stream(weights):
    """One of 3 pools killed mid-stream by the pinned schedule: every
    affected request finishes on a survivor, the full stream equal to its
    solo run; each replay's tail equals a solo run from the replayed
    prefix; the survivors compile nothing after the failover."""
    fs = FaultSchedule({"fabric": {8: "pool_kill:0"}})
    engines = []
    router = FabricRouter(_pool_factory(weights, engines=engines),
                          n_pools=3, queue_depth=16, fault_schedule=fs)
    for r in _trace(*_CHAOS):
        router.submit(r)
    replays, warm = [], None
    while router.queue or any(h.engine.queue or h.engine.pool.active_slots()
                              for h in router.pools.values()):
        router.step()
        if router.counters["pools_died"] and not replays:
            replays = [q for q in router.queue if q.sample_step_base > 0]
        if router.counters["pools_died"] and warm is None and _warm(router):
            warm = {pid: h.engine.exe.compile_count
                    for pid, h in router.pools.items()}
        assert router.now < 3000
    results = dict(router._results)
    stats = router.stats()
    assert stats["pool_kills"] == 1 and stats["pools_died"] == 1
    assert stats["replaced"] > 0, "kill must catch in-flight requests"
    assert {r["status"] for r in results.values()} == {"OK"}
    assert sum(bool(r.get("replayed")) for r in results.values()) \
        == stats["replaced"]
    assert 0 not in router.pools and engines[0].exe._closed
    _assert_solo_exact(weights, results, _CHAOS)
    assert replays, "failover must have enqueued replay requests"
    eng, scope = _pool_factory(weights, n_slots=4)()
    with ptt.scope_guard(scope):
        for rep in replays:
            tail, _ = eng.run(
                [Request(rid="replay-%s" % rep.rid, prompt=rep.prompt,
                         max_new_tokens=rep.max_new_tokens,
                         temperature=rep.temperature, top_k=rep.top_k,
                         top_p=rep.top_p, seed=rep.seed, eos_id=rep.eos_id,
                         sample_step_base=rep.sample_step_base)])
            tail = np.asarray(tail["replay-%s" % rep.rid]["tokens"])
            full = np.asarray(results[rep.rid]["tokens"])
            assert np.array_equal(full[rep.sample_step_base:], tail), rep.rid
    assert warm is not None
    for pid, h in router.pools.items():
        assert h.engine.exe.compile_count == warm[pid], (
            "pool %d compiled after the failover" % pid)


def test_pool_kill_seeded_pick_is_deterministic(weights):
    """A bare `pool_kill` picks its victim off the schedule's seeded
    per-frame hash: two routers with the same seed kill the same pool."""
    victims = []
    for _ in range(2):
        fs = FaultSchedule({"fabric": {6: "pool_kill"}}, seed=11)
        router = FabricRouter(_pool_factory(weights), n_pools=3,
                              queue_depth=16, fault_schedule=fs)
        results, stats = router.run(_trace(10, 1.0, 4))
        assert stats["pool_kills"] == 1
        assert {r["status"] for r in results.values()} == {"OK"}
        victims.append({int(p) for p in stats["pools"]})
    assert victims[0] == victims[1] and len(victims[0]) == 2


def test_dead_step_thread_fails_over_immediately(weights, capsys):
    """An exception inside a pool's step (here an AttributeError: the
    executor is gone) declares the pool dead the SAME step; the gone
    engine's exe (None) is left alone."""
    router = FabricRouter(_pool_factory(weights), n_pools=2, queue_depth=16)
    args = (8, 1.0, 6)
    for r in _trace(*args):
        router.submit(r)
    for _ in range(4):
        router.step()
    victim = sorted(router.pools)[0]
    router.pools[victim].engine.exe = None  # step() will raise
    died_at = router.now
    _drain(router)
    assert victim not in router.pools
    assert router.counters["pools_died"] == 1
    out = capsys.readouterr().out
    assert ("FABRIC POOL STEP DIED pid=%d step=%d: AttributeError"
            % (victim, died_at)) in out
    assert "FABRIC POOL DEAD pid=%d step=%d" % (victim, died_at) in out
    results = dict(router._results)
    assert {r["status"] for r in results.values()} == {"OK"}
    _assert_solo_exact(weights, results, args)


def test_scale_pools_1_3_1_latency_and_no_new_compile(weights):
    """Grow 1 -> 3 at step 5, shrink 3 -> 1 at step 20 under one seeded
    trace: no rejection, every stream OK and solo-exact, p99 latency of
    the 3-pool phase within 2x of a static 3-pool run, no engine
    compiling more than a static pool, retired pools' executors
    closed."""
    args = (24, 1.2, 9, 8)
    t_grow, t_shrink = 5, 20
    static_engines = []
    static = FabricRouter(_pool_factory(weights, engines=static_engines),
                          n_pools=3, queue_depth=64)
    static_res, _ = static.run(_trace(*args))
    engines = []
    router = FabricRouter(_pool_factory(weights, engines=engines),
                          n_pools=1, queue_depth=64)
    results, stats = router.run(_trace(*args),
                                pool_schedule="%d:+2,%d:-2"
                                % (t_grow, t_shrink))
    assert stats["rejected"] == 0 and stats["rejection_rate"] == 0.0
    assert {r["status"] for r in results.values()} == {"OK"}
    assert stats["pools_added"] == 3 and stats["pools_retired"] == 2
    assert stats["n_pools"] == 1
    _assert_solo_exact(weights, results, args)

    def p99(res, lo, hi):
        lats = sorted(r["latency_steps"] for r in res.values()
                      if lo <= r["arrival_step"] < hi)
        return lats[min(len(lats) - 1,
                        int(math.ceil(0.99 * len(lats)) - 1))]

    assert p99(results, t_grow, t_shrink) \
        <= 2 * max(1, p99(static_res, t_grow, t_shrink))
    warm = max(e.exe.compile_count for e in static_engines)
    assert len(engines) == 3
    for e in engines:
        assert e.exe.compile_count <= warm, "scaling caused a compile"
    retired = [e for e in engines
               if all(h.engine is not e for h in router.pools.values())]
    assert len(retired) == 2 and all(e.exe._closed for e in retired)


def test_drain_and_retire_leaves_no_orphans(weights, capsys):
    """drain_pool mid-stream: no new placements, in-flight requests
    finish on their slots, the retired pool ends with no active slot and
    an empty queue, and its executor is closed."""
    engines = []
    router = FabricRouter(_pool_factory(weights, engines=engines),
                          n_pools=2, queue_depth=32)
    args = (10, 1.0, 7)
    for r in _trace(*args):
        router.submit(r)
    drained = None
    while router.queue or any(h.engine.queue or h.engine.pool.active_slots()
                              for h in router.pools.values()):
        router.step()
        if router.now == 5:
            drained = sorted(router.pools)[0]
            router.drain_pool(drained)
        assert router.now < 3000
    assert drained is not None and drained not in router.pools
    stats = router.stats()
    assert stats["pools_retired"] == 1 and stats["replaced"] == 0
    out = capsys.readouterr().out
    assert "FABRIC POOL DRAIN pid=%d step=5" % drained in out
    assert "FABRIC POOL RETIRED pid=%d" % drained in out
    results = dict(router._results)
    assert {r["status"] for r in results.values()} == {"OK"}
    for e in engines:
        assert not e.pool.active_slots() and not e.queue
    assert engines[drained].exe._closed
    _assert_solo_exact(weights, results, args)


def test_scale_down_never_drains_last_pool(weights):
    router = FabricRouter(_pool_factory(weights), n_pools=2, queue_depth=8)
    router.scale_pools(-5)
    assert len(router._live()) == 1


def test_death_report_scale_request_and_proc_kill(weights, capsys):
    """A death report declares its pool dead at the next step; a scale
    request lands at the next step boundary; pool_proc_kill on an
    in-process pool falls back to the cooperative kill."""
    router = FabricRouter(_pool_factory(weights), n_pools=2, queue_depth=8)
    assert router.report_worker_death(pid=1)
    assert not router.report_worker_death(pid=7)
    assert not router.report_worker_death(endpoint="127.0.0.1:1")
    router.request_scale(+1)
    assert len(router.pools) == 2
    router.step()
    assert sorted(router.pools) == [0, 2]
    assert router.counters["pools_died"] == 1
    router.proc_kill_pool(2)
    assert router.counters["pool_kills"] == 1 and router.pools[2].killed
    out = capsys.readouterr().out
    assert "FABRIC POOL DEATH-REPORTED pid=1 step=0" in out
    assert "FABRIC POOL DEAD pid=1 step=0 requeue=0 replay=0" in out
    assert ("FABRIC POOL PROC-KILL pid=2 step=1: in-process pool, falling "
            "back to cooperative kill") in out
    assert "FABRIC POOL KILL pid=2 step=1" in out
    results, stats = router.run(_trace(4, 1.0, 1))
    assert {r["pool"] for r in results.values()} == {0}
    assert stats["pools_died"] == 2 and stats["n_pools"] == 1


def test_router_backpressure_rejects_loudly_at_depth(weights, capsys):
    router = FabricRouter(_pool_factory(weights), n_pools=1, queue_depth=2)
    burst = [Request(rid=i, prompt=np.arange(1, 5), max_new_tokens=6,
                     arrival=0.0) for i in range(8)]
    results, stats = router.run(burst)
    st = [results[i]["status"] for i in range(8)]
    assert st.count("REJECTED_QUEUE_FULL") == 4  # 2 slots + 2 waiting
    assert st.count("OK") == 4
    assert stats["rejected"] == 4 and stats["rejection_rate"] == 0.5
    for i in range(8):
        if results[i]["status"] == "OK":
            assert len(results[i]["tokens"]) == 6
    out = capsys.readouterr().out
    assert "FABRIC REJECTED_QUEUE_FULL rid=4 step=0" in out


def test_router_deadline_expires_waiting_requests(weights):
    router = FabricRouter(_pool_factory(weights), n_pools=1, queue_depth=8)
    reqs = [Request(rid=i, prompt=np.arange(1, 6), max_new_tokens=8,
                    arrival=0.0, deadline=3) for i in range(5)]
    results, stats = router.run(reqs)
    statuses = sorted(results[i]["status"] for i in range(5))
    assert "DEADLINE_EXPIRED" in statuses
    assert set(statuses) <= {"OK", "DEADLINE_EXPIRED"}
    assert stats["expired"] == statuses.count("DEADLINE_EXPIRED")


# ---------------------------------------------------------------------------
# cross-pool and prefix-aware placement
# ---------------------------------------------------------------------------
class Port48(PortHP):
    n_ctx = 48


@pytest.fixture(scope="module")
def weights48():
    """A tiny GPT-2 with positions up to 48, from a seeded port startup."""
    scope = ptt.Scope()
    with ptt.scope_guard(scope), \
            ptt.program_guard(ptt.Program(), ptt.Program()):
        _, start, _, _ = port_gpt2.gpt2_logits_program(Port48, seq_len=48)
        start.random_seed = 7
        ptt.Executor(ptt.CPUPlace()).run(start)
    return {n: scope.find_var(n).numpy() for n in scope.local_var_names()}


def _hetero_router(weights48, queue_depth=8):
    """One SMALL pool (t_max 24) + one BIG pool (t_max 48)."""
    router = FabricRouter(_pool_factory(weights48, hp=Port48, t_max=24),
                          n_pools=1, queue_depth=queue_depth)
    router.pool_factory = _pool_factory(weights48, hp=Port48, t_max=48)
    big = router.add_pool()
    return router, big


def test_cross_pool_placement(weights48):
    """A long request fits only the big pool and lands there; a short
    one prefers the smallest fitting pool; a request no pool fits raises
    at submit; the big pool's death leaves a queued long request
    REJECTED_NO_FIT."""
    router, big = _hetero_router(weights48)
    small = [pid for pid in router.pools if pid != big][0]
    router.submit(Request(rid="L", prompt=np.arange(1, 25),
                          max_new_tokens=12, arrival=0.0))  # 36 > 24 + 1
    router.submit(Request(rid="S", prompt=np.arange(1, 5),
                          max_new_tokens=4, arrival=0.0))
    with pytest.raises(ValueError, match="capacity"):
        router.submit(Request(rid="XXL", prompt=np.arange(1, 41),
                              max_new_tokens=20, arrival=0.0))
    router.step()
    placed = {pid: {s.req.rid for _, s in h.engine.pool.active_slots()}
              for pid, h in router.pools.items()}
    assert "L" in placed[big] and "L" not in placed[small]
    assert "S" in placed[small]
    results, _ = router.run([])
    assert results["L"]["status"] == results["S"]["status"] == "OK"
    assert results["L"]["tokens"].size == 12 and results["L"]["pool"] == big

    router, big = _hetero_router(weights48)
    router.submit(Request(rid="L", prompt=np.arange(1, 25),
                          max_new_tokens=12, arrival=0.0))
    router.kill_pool(big)
    for _ in range(8):  # death declared after miss_beats, then place
        router.step()
        if "L" in router._results:
            break
    assert router._results["L"]["status"] == "REJECTED_NO_FIT"
    assert router.counters["rejected"] == 1


def test_prefix_aware_placement_prefers_resident_pool(weights):
    """A request opening with a registered template lands on the pool
    holding that prefix (less remaining work); cold traffic keeps the
    pid tie-break; the stats surface the per-pool prefix counters; a
    pool added after registration gets the prefix replayed and serves
    a hit equal to the cold stream."""
    with_prefix = _pool_factory(weights, prefix_rows=2)
    router = FabricRouter(_pool_factory(weights), n_pools=1, queue_depth=8)
    router.pool_factory = with_prefix
    pfx_pid = router.add_pool()
    plain_pid = [p for p in router.pools if p != pfx_pid][0]
    tmpl = np.arange(2, 10).astype("int64")  # 8 tokens = 2 chunks
    rows = router.register_prefix(tmpl)
    assert list(rows) == [pfx_pid]  # the plain pool has no cache
    assert router.stats()["prefixes_registered"] == 1
    hit = Request(rid="hit", prompt=np.concatenate(
        [tmpl, np.array([11, 12, 13], "int64")]), max_new_tokens=4,
        arrival=0.0)
    cold = Request(rid="cold", prompt=np.arange(20, 26).astype("int64"),
                   max_new_tokens=4, arrival=0.0)
    router.submit(hit)
    router.submit(cold)
    router.step()
    placed = {pid: {s.req.rid for _, s in h.engine.pool.active_slots()}
              for pid, h in router.pools.items()}
    assert "hit" in placed[pfx_pid], placed
    assert "cold" in placed[plain_pid], placed
    results, stats = router.run([])
    assert {r["status"] for r in results.values()} == {"OK"}
    pp = stats["pools"][str(pfx_pid)]
    assert pp["prefix_hits"] == 1 and pp["prefix_tokens_reused"] == 8
    assert "accept_rate" in pp and "spec_proposed" in pp
    # a pool joining later gets the prefix, and serves a hit there
    router.drain_pool(pfx_pid)
    router.step()
    late_pid = router.add_pool()
    late = router.pools[late_pid]
    with ptt.scope_guard(late.scope):
        assert any(np.array_equal(t, tmpl) for t in
                   late.engine.prefix.registered().values())
    hit2 = Request(rid="hit2", prompt=hit.prompt, max_new_tokens=4,
                   arrival=float(router.now))
    results, stats = router.run([hit2])
    assert results["hit2"]["pool"] == late_pid
    assert stats["pools"][str(late_pid)]["prefix_hits"] == 1
    np.testing.assert_array_equal(results["hit2"]["tokens"],
                                  results["hit"]["tokens"])


def test_stats_per_pool_keys_with_speculative_pool(weights):
    """Two draft="self" pools: every stream equals its run_solo on a
    speculative engine (greedy ones the plain engine's too), and the
    per-pool stats carry the speculation counters."""
    args = (6, 1.0, 2)
    spec = dict(draft="self", spec_k=3)
    router = FabricRouter(_pool_factory(weights, **spec), n_pools=2,
                          queue_depth=8)
    results, stats = router.run(_trace(*args))
    assert {r["status"] for r in results.values()} == {"OK"}
    keys = {"state", "active_slots", "n_slots", "backlog", "compile_count",
            "mean_occupancy", "spec_proposed", "spec_accepted",
            "accept_rate", "prefix_hits", "prefix_misses",
            "prefix_tokens_reused"}
    assert sorted(stats["pools"]) == ["0", "1"]
    for pp in stats["pools"].values():
        assert set(pp) == keys
        assert pp["spec_proposed"] > 0
        assert 0.0 < pp["accept_rate"] <= 1.0
        assert pp["accept_rate"] == round(
            pp["spec_accepted"] / pp["spec_proposed"], 4)
    _assert_solo_exact(weights, results, args, **spec)
    eng, scope = _pool_factory(weights, n_slots=4)()
    with ptt.scope_guard(scope):
        for r in _trace(*args):
            if r.greedy:
                solo, _ = eng.run_solo(r)
                np.testing.assert_array_equal(solo, results[r.rid]["tokens"])


# ---------------------------------------------------------------------------
# port-only rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("member", [
    "pool_mode", "rpc_policy", "attach_worker", "control_service",
    "serve_control", "ProcessPool", "_WireSlot", "_MirrorPool", "_ExeStats"])
def test_process_pool_members_raise(weights, member):
    """What waits for the RPC transport raises, naming ROADMAP A5.4b."""
    with pytest.raises(NotImplementedError, match="ROADMAP A5.4b"):
        if member == "pool_mode":
            FabricRouter(_pool_factory(weights), pool_mode="process")
        elif member == "rpc_policy":
            FabricRouter(_pool_factory(weights), rpc_policy={"retries": 3})
        elif member.startswith("_") or member == "ProcessPool":
            getattr(router_mod, member)("127.0.0.1:0")
        else:
            router = FabricRouter(_pool_factory(weights), n_pools=1)
            getattr(router, member)(*(["127.0.0.1:0"]
                                      if member == "attach_worker" else []))


def _cuda_runtime_error():
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def _cuda_oom():
    raise torch.cuda.OutOfMemoryError("CUDA out of memory.")


def _chained_cuda_error():
    try:
        _cuda_runtime_error()
    except RuntimeError as e:
        raise ValueError("the pooled step failed") from e


def _never_launched(fn_name, *args):
    raise AssertionError("%s launched past a refused input" % fn_name)


_DEVICE_ERRORS = {"cuda_runtime": _cuda_runtime_error, "cuda_oom": _cuda_oom,
                  "chained": _chained_cuda_error}


@pytest.mark.parametrize("kind", ["kernel_launch", "kernel_build",
                                  "kernel_dtype", "kernel_head_dim",
                                  *_DEVICE_ERRORS])
def test_device_error_in_pool_step_propagates(weights, monkeypatch, capsys,
                                              kind):
    """No failover hides the device: a kernel that fails to launch or
    build (build.launch / build.load raising), or that refuses its inputs
    (build.check_inputs refusing a float64 operand; flash_attention_qvec
    refusing the tiny model's head dim 16), each reached through the real
    wrappers with use_kernel forced on, or an error of torch's CUDA
    runtime ends router.step(), with no pool declared dead."""
    router = FabricRouter(_pool_factory(weights), n_pools=2, queue_depth=8)
    for r in _trace(4, 1.0, 1):
        router.submit(r)
    router.step()  # the pools run once on the plain path
    if kind == "kernel_launch":
        def refuse(fn_name, *args):
            raise build.KernelError("%s: CUDA error 700 (an illegal memory "
                                    "access was encountered)" % fn_name)

        monkeypatch.setattr(build, "use_kernel",
                            lambda t: t.device.type != "meta")
        monkeypatch.setattr(build, "launch", refuse)
    elif kind == "kernel_build":
        def no_nvcc():
            raise build.KernelError("nvcc failed:\n== matmul_bias_act.cu")

        monkeypatch.setattr(build, "use_kernel",
                            lambda t: t.device.type != "meta")
        monkeypatch.setattr(build, "load", no_nvcc)
    elif kind == "kernel_dtype":
        real_check = build.check_inputs

        def float64_first(name, *tensors):
            real_check(name, tensors[0].double(), *tensors[1:])

        monkeypatch.setattr(build, "use_kernel",
                            lambda t: t.device.type != "meta")
        monkeypatch.setattr(build, "check_inputs", float64_first)
        monkeypatch.setattr(build, "launch", _never_launched)
    elif kind == "kernel_head_dim":
        # the kernels before attention "launch" as no-ops, so the step
        # reaches flash_attention_qvec's own check
        monkeypatch.setattr(build, "use_kernel",
                            lambda t: t.device.type != "meta")
        monkeypatch.setattr(build, "launch", lambda fn_name, *args: None)
    else:
        victim = router.pools[sorted(router.pools)[0]].engine
        monkeypatch.setattr(victim, "step", _DEVICE_ERRORS[kind])
    with pytest.raises(Exception) as err:
        router.step()
    assert router_mod._device_error(err.value)
    chain, e = [], err.value
    while e is not None:
        chain.append(e)
        e = e.__cause__ or e.__context__
    if kind.startswith("kernel"):  # the executor wraps it with the op
        assert any(isinstance(e, build.KernelError) for e in chain), chain
    refused = {"kernel_dtype": (build.KernelTypeError, TypeError, "float32"),
               "kernel_head_dim": (build.KernelInputError, ValueError,
                                   "head dims 64 and 128")}.get(kind)
    if refused:
        kernel_kind, builtin, text = refused
        hit = [e for e in chain if isinstance(e, kernel_kind)]
        assert hit and isinstance(hit[0], builtin), chain
        assert text in str(hit[0]), hit[0]
    assert router.counters["pools_died"] == 0 and len(router.pools) == 2
    assert "FABRIC POOL STEP DIED" not in capsys.readouterr().out


def test_kernel_modules_refuse_only_with_kernel_errors():
    """Every raise in the kernel modules is a KernelError (a refusal of
    inputs a KernelInputError / KernelTypeError, which stay ValueError /
    TypeError), so the fabric's failover can tell a kernel's refusal from
    a host error."""
    kernels_dir = os.path.dirname(build.__file__)
    bare = []
    for fname in sorted(os.listdir(kernels_dir)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(kernels_dir, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and isinstance(node.exc.func, ast.Name)
                    and node.exc.func.id in ("ValueError", "TypeError",
                                             "RuntimeError")):
                bare.append("%s:%d" % (fname, node.lineno))
    assert not bare, bare
    for kind, builtin in ((build.KernelInputError, ValueError),
                          (build.KernelTypeError, TypeError)):
        err = kind("refused")
        assert isinstance(err, builtin) and isinstance(err, build.KernelError)
        assert router_mod._device_error(err)
    assert not router_mod._device_error(ValueError("a host value"))


def test_host_errors_still_fail_over(weights):
    """The other side of the rule: an AttributeError (the reference
    tests' dead step thread) or a plain RuntimeError fails the pool over
    and the fabric finishes every request."""
    assert not router_mod._device_error(AttributeError("exe"))
    assert not router_mod._device_error(RuntimeError("Executor is closed"))
    router = FabricRouter(_pool_factory(weights), n_pools=2, queue_depth=8)
    for r in _trace(6, 1.0, 1):
        router.submit(r)
    router.step()

    def closed():
        raise RuntimeError("Executor is closed")

    router.pools[0].engine.step = closed
    _drain(router)
    assert router.counters["pools_died"] == 1 and 0 not in router.pools
    assert {r["status"] for r in router._results.values()} == {"OK"}


def test_gone_pool_executor_is_closed_and_counts_read(weights):
    """A killed pool's executor is closed once its requests are re-placed
    (run raises), and its compile_count reads what it read before."""
    engines = []
    router = FabricRouter(_pool_factory(weights, engines=engines),
                          n_pools=2, queue_depth=8)
    for r in _trace(6, 1.0, 1):
        router.submit(r)
    for _ in range(3):
        router.step()
    before = engines[1].exe.compile_count
    assert before > 0 and not engines[1].exe._closed
    router.kill_pool(1)
    _drain(router)
    assert router.counters["pools_died"] == 1
    assert engines[1].exe._closed and not engines[0].exe._closed
    assert engines[1].exe.compile_count == before
    with pytest.raises(RuntimeError, match="closed"):
        engines[1].exe.run(engines[1].cache_startup)
