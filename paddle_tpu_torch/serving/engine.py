"""Continuous-batching serving engine (the counterpart of
``paddle_tpu/serving/engine.py``).

ONE ragged wide-step program (gpt2_ragged_step_program: width W over a
fixed pool of B cache slots) serves every request.  Each engine step
the scheduler

  1. admits queued requests (arrival <= now) into free slots, zeroing
     just those slots' cache rows through the slot-reset program,
  2. dispatches the pooled step: prompt-prefill chunks for newly
     admitted requests interleaved with one-token decode for in-flight
     ones (per-slot pos/width vectors drive slot_cache_write and the
     per-row offset-causal attention),
  3. samples each due row on the host with that request's own params
     and keyed rng (decode_cache.filtered_probs_rows /
     sample_rows_keyed),
  4. evicts finished slots immediately.

Exactness contract: every request's emitted tokens are bit-identical
to its solo run through the same engine (greedy, and sampled given the
same per-request seed), whatever shares the batch — row-independent
math in the pooled step (every kernel of it computes a row from that
row alone) plus per-request sampling keys.  Occupancy changes only
change feed values, never shapes, so the executor builds the step's
run plan once (Executor.compile_count).

The constructor takes the reference's parameters in the reference's
order.  Not ported yet, each raising NotImplementedError when set:
in-pool speculative decoding (`draft`, `spec_k`), the prefix cache
(`prefix_rows`, `prefix_chunk`), weight-only int8 (`quantize_int8`) and
tensor-parallel pools (`mesh`), ROADMAP A5; the pools' sharding
(`partition_rules`, `mp_axis`), A7; a `cache_dtype` other than
"float32" (the bf16 kernel forms), A3.
"""

import time

import numpy as np

from ..profiler import RecordEvent
from .pool import PREFILL

__all__ = ["ServingEngine", "serve_one_at_a_time"]


class ServingEngine:
    """exe: Executor whose scope already holds the model weights (the
    ragged program shares parameter names with gpt2_logits_program —
    run its startup, or load weights with io.params_from_numpy, before
    serving)."""

    def __init__(self, exe, hp, n_slots=4, width=8, t_max=None,
                 cache_dtype="float32", quantize_int8=False,
                 queue_depth=None, mesh=None, partition_rules=None,
                 mp_axis=None, draft=None, spec_k=None, prefix_rows=0,
                 prefix_chunk=None):
        for flag, what, item in (
                (str(cache_dtype) != "float32",
                 "cache_dtype %r (bf16 KV caches)" % (cache_dtype,), "A3"),
                (quantize_int8, "quantize_int8 (weight-only int8 serving)",
                 "A5"),
                (mesh, "mesh (tensor-parallel pools)", "A5"),
                (partition_rules, "partition_rules (tensor-parallel pools)",
                 "A7"),
                (mp_axis, "mp_axis (tensor-parallel pools)", "A7"),
                (draft, "draft (in-pool speculative decoding)", "A5"),
                (spec_k, "spec_k (in-pool speculative decoding)", "A5"),
                (prefix_rows, "prefix_rows (prefix-cache KV reuse)", "A5"),
                (prefix_chunk, "prefix_chunk (prefix-cache KV reuse)",
                 "A5")):
            if flag:
                raise NotImplementedError(
                    "ServingEngine: %s is not ported yet (ROADMAP %s)"
                    % (what, item))
        from ..models import gpt2
        from ..models.decode_cache import make_slot_reset_program
        from .pool import SlotPool

        self.exe = exe
        self.hp = hp
        self.n_slots = int(n_slots)
        self.width = int(width)
        self.t_max = int(t_max or hp.n_ctx)
        (self.step_main, self.cache_startup, self._feeds, self.step_fetch,
         self.cache_names) = gpt2.gpt2_ragged_step_program(
            hp, batch=self.n_slots, t_max=self.t_max, width=self.width)
        dh = hp.d_model // hp.n_head
        n_kv = getattr(hp, "n_kv_head", None) or hp.n_head
        self.reset_prog = make_slot_reset_program(
            [(n, (self.n_slots, n_kv, self.t_max, dh))
             for n in self.cache_names],
            self.n_slots)
        self.pool = SlotPool(self.n_slots, self.width, self.t_max)
        self.queue = []  # submitted, not yet admitted (arrival order)
        # admission control: an arrival that finds `queue_depth` requests
        # already waiting is rejected with REJECTED_QUEUE_FULL
        self.queue_depth = None if queue_depth is None else int(queue_depth)
        assert self.queue_depth is None or self.queue_depth >= 0
        self.now = 0
        self.counters = {"steps": 0, "admitted": 0, "finished": 0,
                         "new_tokens": 0, "occupancy_sum": 0.0,
                         "prefill_steps": 0, "decode_steps": 0,
                         "rejected": 0, "expired": 0, "prefill_chunks": 0}
        self._step_wall = []
        self.step_seconds = []  # wall time of each dispatching step
        self._results = {}

    # ---- request intake ------------------------------------------------
    def submit(self, req):
        self.pool.validate(req)
        live = {q.rid for q in self.queue}
        live.update(s.req.rid for _, s in self.pool.active_slots())
        if req.rid in live:
            raise ValueError("duplicate request id %r" % (req.rid,))
        self.queue.append(req)
        self.queue.sort(key=lambda r: (r.arrival, r.rid))

    # ---- one scheduler iteration --------------------------------------
    def _result(self, req, status, slot_state=None):
        wall = time.time()
        a = min(req.arrival_step, max(0, len(self._step_wall) - 1))
        return {
            "tokens": np.asarray(
                slot_state.out if slot_state is not None else [], "int64"),
            "prompt_len": int(req.prompt.size),
            "arrival_step": req.arrival_step,
            "admit_step": (slot_state.admit_step
                           if slot_state is not None else None),
            "finish_step": self.now,
            "status": status,
            "latency_steps": self.now - req.arrival_step + 1,
            "latency_s": wall - (self._step_wall[a] if self._step_wall
                                 else wall),
        }

    def _terminal(self, req, status, slot_state=None):
        """A terminal non-OK outcome: rejected at admission or expired."""
        self.counters["rejected" if status == "REJECTED_QUEUE_FULL"
                      else "expired"] += 1
        print("SERVE %s rid=%r step=%d" % (status, req.rid, self.now),
              flush=True)
        self._results[req.rid] = self._result(req, status, slot_state)

    def step(self):
        """Admit -> pooled dispatch -> sample -> evict.  Returns the ids
        of requests that reached a terminal state this step."""
        terminal = []
        with RecordEvent("serve_admit", cat="admit"):
            for slot, s in self.pool.active_slots():
                d = s.req.deadline
                if d is not None and self.now >= s.req.arrival_step + d:
                    self.pool.evict(slot)
                    self._terminal(s.req, "DEADLINE_EXPIRED", s)
                    terminal.append(s.req.rid)
            keep = np.ones(self.n_slots, "float32")
            admitted = False
            waiting = 0
            still = []
            for req in self.queue:  # arrival order
                d = req.deadline
                if req.arrival > self.now:
                    still.append(req)
                elif d is not None and self.now >= req.arrival_step + d:
                    self._terminal(req, "DEADLINE_EXPIRED")
                    terminal.append(req.rid)
                elif self.pool.free_slots():
                    slot = self.pool.admit(req, self.now)
                    keep[slot] = 0.0
                    admitted = True
                    self.counters["admitted"] += 1
                elif self.queue_depth is None or waiting < self.queue_depth:
                    waiting += 1
                    still.append(req)
                else:
                    self._terminal(req, "REJECTED_QUEUE_FULL")
                    terminal.append(req.rid)
            self.queue = still
            if admitted:
                # zero exactly the admitted slots' cache rows
                self.exe.run(self.reset_prog, feed={"slot_keep": keep},
                             fetch_list=[])
        active = self.pool.active_slots()
        if not active:
            self.now += 1
            return terminal
        t0 = time.perf_counter()
        feed, plan = self.pool.build_feed(self.hp.n_ctx)
        self.counters["prefill_chunks"] += sum(
            1 for _, s in active if s.state == PREFILL)
        phase = "prefill" if self.pool.any_prefilling() else "decode"
        self.counters[phase + "_steps"] += 1
        with RecordEvent("serve_step", cat=phase):
            (logits,) = self.exe.run(self.step_main, feed=feed,
                                     fetch_list=self.step_fetch)
        finished = []
        with RecordEvent("serve_sample", cat="sample"):
            due = {slot for slot, _ in plan}
            for slot, s in active:
                if slot not in due:
                    self.pool.advance_prefill(slot)
            if plan:
                rows = np.stack([logits[slot, col] for slot, col in plan])
                toks = self._pick_tokens(rows, [s for s, _ in plan])
                for (slot, _), tok in zip(plan, toks):
                    s = self.pool.slots[slot]
                    self.counters["new_tokens"] += 1
                    if self.pool.advance(slot, tok):
                        self._finish(slot)
                        finished.append(s.req.rid)
        self.step_seconds.append(time.perf_counter() - t0)
        self.counters["steps"] += 1
        self.counters["occupancy_sum"] += len(active) / self.n_slots
        self.now += 1
        return terminal + finished

    def _pick_tokens(self, rows, slots):
        """Per-row token selection with per-request params: greedy rows
        argmax, sampled rows draw from their filtered row with the keyed
        fold_in(seed, request_step) stream — a pure function of
        (request, step), neighbours invisible."""
        from ..models.decode_cache import filtered_probs_rows, sample_rows_keyed

        rows = np.asarray(rows)
        sl = [self.pool.slots[s] for s in slots]
        greedy = np.array([s.req.greedy for s in sl], bool)
        out = np.zeros(len(slots), "int64")
        if greedy.any():
            out[greedy] = rows[greedy].argmax(axis=-1)
        samp = np.nonzero(~greedy)[0]
        if samp.size:
            ss = [sl[j] for j in samp]
            probs = filtered_probs_rows(
                rows[samp], [s.req.temperature for s in ss],
                [s.req.top_k for s in ss], [s.req.top_p for s in ss])
            steps = [len(s.out) + s.req.sample_step_base for s in ss]
            out[samp] = sample_rows_keyed(probs, [s.req.seed for s in ss],
                                          steps)
        return out

    def _finish(self, slot):
        s = self.pool.evict(slot)
        self.counters["finished"] += 1
        self._results[s.req.rid] = self._result(s.req, "OK", s)

    # ---- control-plane snapshot ----------------------------------------
    def stats(self):
        """Counters snapshot (the shape the reference's `stats` verb
        surfaces per pool)."""
        c = dict(self.counters)
        c["compile_count"] = int(self.exe.compile_count)
        return c

    # ---- episode drivers ----------------------------------------------
    def run(self, requests=None, max_steps=100000):
        """Serve `requests` (plus anything already queued) to completion:
        zero the caches, loop step() until drained.  Returns (results,
        stats)."""
        self.now = 0
        self._step_wall = []
        self.step_seconds = []
        self._results = {}
        for k in self.counters:
            self.counters[k] = 0
        for r in requests or []:
            self.submit(r)
        self.exe.run(self.cache_startup)
        t0 = time.time()
        while self.queue or self.pool.active_slots():
            self._step_wall.append(time.time())
            self.step()
            if self.now >= max_steps:
                n_left = len(self.queue) + len(self.pool.active_slots())
                self.queue = []
                for slot, _ in self.pool.active_slots():
                    self.pool.evict(slot)
                raise RuntimeError(
                    "serving engine exceeded max_steps=%d with %d requests "
                    "unfinished (state cleared; finished results discarded)"
                    % (max_steps, n_left))
        wall = time.time() - t0
        c = dict(self.counters)
        steps = max(1, c.pop("steps"))
        stats = {
            "steps": steps,
            "wall_s": round(wall, 4),
            "tokens_per_s": round(c["new_tokens"] / wall, 1) if wall else 0.0,
            "occupancy_pct": round(100.0 * c.pop("occupancy_sum") / steps, 1),
            "step_s_mean": wall / steps,
            "step_s_p50": (float(np.median(self.step_seconds))
                           if self.step_seconds else 0.0),
            "compile_count": self.exe.compile_count,
        }
        stats.update(c)
        return self._results, stats

    def run_solo(self, req):
        """Serve ONE request through the same pooled program with every
        other slot free — the exactness reference.  Returns (tokens,
        stats)."""
        if self.queue or self.pool.active_slots():
            raise RuntimeError("run_solo on a busy engine")
        from .trace import Request

        solo = Request(rid=req.rid, prompt=req.prompt,
                       max_new_tokens=req.max_new_tokens,
                       temperature=req.temperature, top_k=req.top_k,
                       top_p=req.top_p, seed=req.seed, eos_id=req.eos_id,
                       arrival=0.0)
        results, stats = self.run([solo])
        return results[req.rid]["tokens"], stats


def serve_one_at_a_time(engine, requests, arrival_step_seconds=None):
    """The A/B baseline: the same trace served sequentially, each request
    owning the whole pool (run_solo).  Latency replays the virtual
    arrival clock (arrival steps mapped to seconds by
    `arrival_step_seconds`).  Returns (results, stats)."""
    results = {}
    svc_total = 0.0
    tokens_total = 0
    step_s = float(arrival_step_seconds or 0.0)
    finish_v = 0.0
    for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        t0 = time.time()
        tokens, _ = engine.run_solo(req)
        svc = time.time() - t0
        svc_total += svc
        tokens_total += int(tokens.size)
        arrive_v = req.arrival_step * step_s
        finish_v = max(arrive_v, finish_v) + svc
        results[req.rid] = {"tokens": tokens,
                            "prompt_len": int(req.prompt.size),
                            "latency_s": finish_v - arrive_v,
                            "service_s": svc}
    stats = {"wall_s": round(svc_total, 4),
             "tokens_per_s": (round(tokens_total / svc_total, 1)
                              if svc_total else 0.0),
             "new_tokens": tokens_total}
    return results, stats
