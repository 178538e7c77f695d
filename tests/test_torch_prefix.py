"""The prefix cache in paddle_tpu_torch against the reference on the CPU,
at the narrow GPT-2 of tests/test_torch_serving.py (vocab 61, d_model 64,
2 layers, 4 heads; a one-layer draft in its own scope):

- make_row_copy_program: the reference's ops, and load and store on
  seeded random caches equal to the reference's, exactly;
- make_prefix_trace byte-equal to the reference's for a seed;
- PrefixCache's host index (match, the chunk floor and the prompt_len -
  1 cap, dedup, eviction of the least recently matched row, counters)
  against the reference's through the same calls;
- SlotPool.fits, occupancy and admit(prefix_len=), with the reference's
  asserts;
- the prefix engine, plain and speculative (draft "self" and the
  separate draft), against the reference engine on a small prefix
  trace in lockstep: feeds, target and draft logits at every step, the
  token decisions, the prefix and spec counters;
- the port's own contracts: a prefix hit's stream equals the cold
  one bit for bit with fewer prefill chunks, pooled == run_solo, no
  re-plan across the churn; register_prefix / observe_prefixes as the
  reference (dedup, the chunk floor, mining) and raising on an engine
  built without prefix_rows; kv_pool_bytes on the CPU."""

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu.models import decode_cache as ref_dc
from paddle_tpu.serving import Request as RefRequest
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import pool as ref_pool
from paddle_tpu.serving import prefix as ref_prefix
from paddle_tpu.serving import trace as ref_trace
import paddle_tpu_torch as ptt
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import decode_cache as port_dc
from paddle_tpu_torch.serving import (PrefixCache, Request, ServingEngine,
                                      SlotPool, make_prefix_trace)
from paddle_tpu_torch.serving import pool as port_pool

from test_torch_program import _assert_same_program
from test_torch_speculative import (PortHP, RefHP, _assert_same_dispatches,
                                    _reference_weights, _spec_engines,
                                    fresh_port_state)  # noqa: F401

PREFIX_ENGINE = dict(n_slots=4, width=4, t_max=24, prefix_rows=2,
                     prefix_chunk=4)


def _trace_and_templates(request_cls, seed=0):
    """8 requests, 2 templates of 12 tokens, 90% reuse, half sampled."""
    make = (ref_trace.make_prefix_trace if request_cls is RefRequest
            else make_prefix_trace)
    return make(8, rate=0.7, n_prefixes=2, prefix_len=12,
                tail_len_range=(1, 3), out_len_range=(3, 6), vocab_size=61,
                seed=seed, reuse_fraction=0.9)


def _trace(request_cls):
    return _trace_and_templates(request_cls)[0]


# ---------------------------------------------------------------------------
# the row-copy program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["load", "store"])
def test_row_copy_program_matches_reference(direction):
    """The reference's ops, and the copy itself on seeded random caches:
    load gathers prefix rows into the taken slots, store one slot into
    one prefix row; every other row keeps its bytes."""
    R, B, H, T, D = 3, 4, 2, 6, 3
    pfx, slot = ("pfx_c", (R, H, T, D)), ("slot_c", (B, H, T, D))
    src, dst = (pfx, slot) if direction == "load" else (slot, pfx)
    n_dst = dst[1][0]
    with pfluid.unique_name.guard():
        ref = ref_dc.make_row_copy_program([src + dst], n_dst)
    port = port_dc.make_row_copy_program([src + dst], n_dst)
    _assert_same_program(ref, port)
    rng = np.random.RandomState(2 if direction == "load" else 3)
    arrays = {pfx[0]: rng.rand(*pfx[1]).astype("float32"),
              slot[0]: rng.rand(*slot[1]).astype("float32")}
    if direction == "load":
        rows = np.array([2, 0, 1, 0], "int64")
        take = np.array([1, 0, 1, 0], "float32")
    else:
        rows = np.full(R, 2, "int64")
        take = np.array([0, 1, 0], "float32")
    feed = {"copy_src_rows": rows, "copy_take": take, "copy_keep": 1 - take}
    with pfluid.scope_guard(pfluid.Scope()):
        scope = pfluid.global_scope()
        for n, a in arrays.items():
            scope.set(n, a.copy())
        pfluid.Executor(pfluid.CPUPlace()).run(ref, feed=feed, fetch_list=[])
        want = np.asarray(scope.find_var(dst[0]))
    scope = ptt.Scope()
    params_from_numpy(arrays, scope, ptt.CPUPlace())
    ptt.Executor(ptt.CPUPlace()).run(port, feed=feed, fetch_list=[],
                                     scope=scope)
    got = scope.find_var(dst[0]).numpy()
    assert got.tobytes() == want.tobytes()
    for i in range(n_dst):
        expect = (arrays[src[0]][rows[i]] if take[i]
                  else arrays[dst[0]][i])
        np.testing.assert_array_equal(got[i], expect)


def test_row_copy_program_is_float32_only():
    """A bf16 pair (once refused, now ported: bf16 prefix banks) builds
    the reference's program, the float32 masks' product cast back to
    bf16 before the assign."""
    pair = [("a", (2, 1, 4, 2), "b", (2, 1, 4, 2), "bfloat16")]
    with pfluid.unique_name.guard():
        ref = ref_dc.make_row_copy_program(pair, 2)
    port = port_dc.make_row_copy_program(pair, 2)
    _assert_same_program(ref, port)
    types = [o.type for o in port.global_block().ops]
    assert types[-2:] == ["cast", "assign"]
    assert str(port.global_block().vars["b"].dtype) == "bfloat16"


# ---------------------------------------------------------------------------
# the trace, the host index, the pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 9])
def test_prefix_trace_byte_equal_to_reference(seed):
    ref_reqs, ref_pfx = _trace_and_templates(RefRequest, seed)
    reqs, pfx = _trace_and_templates(Request, seed)
    assert len(pfx) == len(ref_pfx) == 2
    for p, q in zip(pfx, ref_pfx):
        assert p.dtype == q.dtype and p.tobytes() == q.tobytes()
    assert len(reqs) == len(ref_reqs) == 8
    for a, b in zip(reqs, ref_reqs):
        assert a.prompt.dtype == b.prompt.dtype
        assert a.prompt.tobytes() == b.prompt.tobytes()
        for key in ("rid", "max_new_tokens", "temperature", "top_k", "top_p",
                    "seed", "eos_id", "arrival", "arrival_step", "deadline",
                    "sample_step_base", "greedy"):
            assert getattr(a, key) == getattr(b, key), key
    assert sum(any(np.array_equal(r.prompt[:12], p) for p in pfx)
               for r in reqs) >= 6


def _index_calls(rng):
    """A seeded sequence of host-index calls: registrations (some exact
    repeats, some sub-chunk), matches of template-led prompts and of
    cold ones, hits, misses, one invalidation."""
    bases = [rng.randint(1, 61, 14).astype("int64") for _ in range(4)]
    calls = []
    for i in range(60):
        kind = rng.randint(0, 5)
        b = bases[rng.randint(0, 4)]
        if kind == 0:
            calls.append(("assign", b[:4 * rng.randint(1, 4)]))
        elif kind in (1, 2):
            n = int(rng.randint(1, 16))
            tail = rng.randint(1, 61, rng.randint(0, 4)).astype("int64")
            calls.append(("match", np.concatenate([b[:n], tail])))
        elif kind == 3:
            calls.append(("miss",))
        else:
            calls.append(("match", rng.randint(1, 61, 9).astype("int64")))
        if i == 40:
            calls.append(("invalidate",))
    return calls


@pytest.mark.parametrize("rows, chunk", [(2, 4), (3, 8)])
def test_prefix_cache_host_index_matches_reference(rows, chunk):
    port, ref = PrefixCache(rows, chunk), ref_prefix.PrefixCache(rows, chunk)
    outcomes = set()
    for call in _index_calls(np.random.RandomState(rows)):
        name, args = call[0], call[1:]
        got, want = getattr(port, name)(*args), getattr(ref, name)(*args)
        assert got == want, (call, got, want)
        if name == "match" and got[0] is not None:
            port.touch(*got)
            ref.touch(*want)
            outcomes.add(got[1])
        elif name == "assign":
            outcomes.add(got)
        got_reg, want_reg = port.registered(), ref.registered()
        assert sorted(got_reg) == sorted(want_reg)
        for r in got_reg:
            np.testing.assert_array_equal(got_reg[r], want_reg[r])
    assert port.counters() == ref.counters()
    assert port.evictions > 0 and port.hits > 3 and len(outcomes) > 4


def _req(cls, n_prompt, new=4, rid=0):
    return cls(rid=rid, prompt=np.arange(1, n_prompt + 1, dtype="int64"),
               max_new_tokens=new)


def test_slot_pool_fits_occupancy_and_prefix_admission():
    port, ref = SlotPool(3, 4, 16), ref_pool.SlotPool(3, 4, 16)
    for n_prompt, new in ((12, 5), (12, 6), (1, 16), (2, 16)):
        assert port.fits(_req(Request, n_prompt, new)) == ref.fits(
            _req(RefRequest, n_prompt, new))
    assert port.fits(_req(Request, 12, 5))
    assert not port.fits(_req(Request, 12, 6))
    for pool, cls in ((port, Request), (ref, RefRequest)):
        assert pool.occupancy() == 0.0
        slot = pool.admit(_req(cls, 9), 0, prefix_len=8)
        s = pool.slots[slot]
        assert (s.prefix_len, s.prefill_pos, s.pos) == (8, 8, 8)
        assert (s.spec_proposed, s.spec_accepted) == (0, 0)
        pool.admit(_req(cls, 5, rid=1), 0)
        assert pool.occupancy() == pytest.approx(2 / 3)
        feed, plan = pool.build_feed(24)
        assert feed["pos_rows"][slot] == 8 and feed["width_rows"][slot] == 1
        assert plan[0] == (slot, 0)
    for prefix_len, n_prompt in ((6, 9), (8, 8), (12, 9)):
        for pool, cls in ((SlotPool(2, 4, 16), Request),
                          (ref_pool.SlotPool(2, 4, 16), RefRequest)):
            with pytest.raises(AssertionError):
                pool.admit(_req(cls, n_prompt), 0, prefix_len=prefix_len)
    assert port_pool._Slot.__slots__ == ref_pool._Slot.__slots__


# ---------------------------------------------------------------------------
# the prefix engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[None, "self", "separate"],
                ids=["plain", "self", "separate"])
def prefix_engines(request):
    _, templates = _trace_and_templates(Request)
    return _spec_engines(request.param, PREFIX_ENGINE, _trace, templates)


def test_prefix_engine_matches_reference(prefix_engines):
    e = prefix_engines
    _assert_same_dispatches(e["ref_rec"].steps, e["port_rec"].steps,
                            "target step", 6)
    _assert_same_dispatches(e["ref_draft"].steps, e["port_draft"].steps,
                            "draft step", -1)
    ref, port = e["ref_rules"].log, e["port_rules"].log
    assert [r for r, _, _ in port] == [r for r, _, _ in ref]
    for i, ((rule, _, mine), (_, _, want)) in enumerate(zip(port, ref)):
        if rule == "_resolve_spec_row":
            assert tuple(mine) == tuple(want), i
        else:
            np.testing.assert_array_equal(np.asarray(mine),
                                          np.asarray(want), err_msg=str(i))
    assert e["port_stats"]["prefix_hits"] >= 5
    for key in ("steps", "finished", "new_tokens", "prefill_chunks",
                "prefix_hits", "prefix_misses", "prefix_tokens_reused",
                "prefix_hit_rate", "spec_rounds", "spec_proposed",
                "spec_accepted", "draft_steps", "accept_rate"):
        assert e["port_stats"][key] == e["ref_stats"][key], key
    for rid, r in e["ref_results"].items():
        p = e["port_results"][rid]
        assert p["status"] == r["status"] == "OK"
        assert (p["prefix_len"], p["spec_proposed"], p["spec_accepted"]) == (
            r["prefix_len"], r["spec_proposed"], r["spec_accepted"])
        np.testing.assert_array_equal(p["tokens"], r["tokens"])


def test_prefix_hit_equals_cold(prefix_engines):
    """The port's own picks: with the templates registered every stream
    equals a cold engine's bit for bit, with fewer prefill chunks; each
    equals its run_solo; the churn never re-plans; the counters."""
    eng = prefix_engines["port_eng"]
    scope = prefix_engines["port_scope"]
    reqs, templates = _trace_and_templates(Request)
    with ptt.scope_guard(scope):
        warm, wst = eng.run(reqs)
        plans = eng.exe.compile_count
        for r in reqs:
            solo, _ = eng.run_solo(r)
            np.testing.assert_array_equal(warm[r.rid]["tokens"], solo)
        assert eng.exe.compile_count == plans
        kw = dict(PREFIX_ENGINE, prefix_rows=0, prefix_chunk=None)
        if eng.spec_k:
            kw.update(draft=("self" if eng.draft_scope is None
                             else (eng.draft_hp, eng.draft_scope)),
                      spec_k=eng.spec_k)
        cold_eng = ServingEngine(ptt.Executor(ptt.CPUPlace()), PortHP, **kw)
        cold, cst = cold_eng.run(reqs)
    hits = [r for r in reqs if warm[r.rid]["prefix_len"]]
    assert len(hits) == wst["prefix_hits"] >= 5
    assert all(warm[r.rid]["prefix_len"] == 12 for r in hits)
    assert cst["prefix_hits"] == 0 and cst["prefix_hit_rate"] == 0.0
    assert cst["prefill_chunks"] - wst["prefill_chunks"] == 3 * len(hits)
    assert wst["prefix_tokens_reused"] == 12 * len(hits)
    for r in reqs:
        np.testing.assert_array_equal(warm[r.rid]["tokens"],
                                      cold[r.rid]["tokens"],
                                      err_msg="rid %r" % r.rid)
    s = eng.stats()
    assert s["prefix_registrations"] == len(templates) == s[
        "prefix_rows_used"]
    assert s["prefix_lifetime_hits"] >= 2 * len(hits)
    assert s["prefix_chunk"] == 4 and s["spec_on"] == bool(eng.spec_k)
    kv = eng.kv_pool_bytes(scope)
    assert kv["per_device_bytes"] == {"cpu": kv["total_bytes"]}
    assert kv["total_bytes"] == kv["max_device_bytes"] == (
        2 * PortHP.n_layer * 4 * PortHP.n_head * 24
        * (PortHP.d_model // PortHP.n_head) * 4)


def test_register_and_observe_prefixes_as_the_reference():
    """register_prefix floors to the chunk, dedups without a prefill and
    returns None under a chunk; observe_prefixes mines the openings that
    requests share, the same rows and tokens as the reference's; both
    raise on an engine built without prefix_rows."""
    weights = _reference_weights()
    reqs33, _ = _trace_and_templates(Request, seed=33)
    ref_reqs33, _ = _trace_and_templates(RefRequest, seed=33)
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()), \
            pfluid.scope_guard(pfluid.Scope()):
        for n, w in weights.items():
            pfluid.global_scope().set(n, w)
        exe = pfluid.Executor(pfluid.CPUPlace())
        ref = RefEngine(exe, RefHP, **PREFIX_ENGINE)
        want = [ref.register_prefix(np.array([1, 2, 3], "int64")),
                ref.register_prefix(np.arange(1, 11, dtype="int64")),
                ref.register_prefix(np.arange(1, 9, dtype="int64")),
                ref.prefix.match(np.arange(1, 13, dtype="int64")),
                ref.observe_prefixes(ref_reqs33, min_count=2),
                ref.prefix.counters()]
        want_reg = ref.prefix.registered()
        with pytest.raises(RuntimeError, match="prefix_rows"):
            RefEngine(exe, RefHP, n_slots=2, width=4,
                      t_max=24).register_prefix(np.arange(8))
    scope = ptt.Scope()
    params_from_numpy(weights, scope, ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        eng = ServingEngine(exe, PortHP, **PREFIX_ENGINE)
        got = [eng.register_prefix(np.array([1, 2, 3], "int64")),
               eng.register_prefix(np.arange(1, 11, dtype="int64")),
               eng.register_prefix(np.arange(1, 9, dtype="int64")),
               eng.prefix.match(np.arange(1, 13, dtype="int64")),
               eng.observe_prefixes(reqs33, min_count=2),
               eng.prefix.counters()]
        plain = ServingEngine(exe, PortHP, n_slots=2, width=4, t_max=24)
        for call in (lambda: plain.register_prefix(np.arange(8)),
                     lambda: plain.observe_prefixes(reqs33)):
            with pytest.raises(RuntimeError, match="prefix_rows"):
                call()
        eng.submit(reqs33[0])
        with pytest.raises(RuntimeError, match="busy"):
            eng.register_prefix(np.arange(1, 9, dtype="int64"))
    assert got == want
    assert got[0] is None and got[1] == got[2] and got[3] == (got[1], 8)
    assert got[4], "the shared templates are mined"
    reg = eng.prefix.registered()
    assert sorted(reg) == sorted(want_reg)
    for r in reg:
        np.testing.assert_array_equal(reg[r], want_reg[r])
    assert got[5]["prefix_registrations"] >= 2
