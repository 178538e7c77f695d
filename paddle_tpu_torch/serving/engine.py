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

Two options of the reference ride on that loop:

- in-pool speculative decoding (`draft`, `spec_k`): a draft model (the
  target itself over a second KV pool, draft="self", or a smaller model
  in its own scope, draft=(draft_hp, draft_scope)) proposes up to
  spec_k - 1 tokens for each decoding slot through its own ragged step,
  and the one target dispatch verifies them in the widened rows;
- the prefix cache (`prefix_rows`, `prefix_chunk`; serving/prefix.py):
  admission longest-matches a prompt against registered prefixes and
  copies their KV rows into the slot, so prefill starts at the match.

Exactness contract: every request's emitted tokens are bit-identical
to its solo run through the same engine (greedy, and sampled given the
same per-request seed), whatever shares the batch — row-independent
math in the pooled step (every kernel of it computes a row from that
row alone) plus per-request sampling keys.  Occupancy changes only
change feed values, never shapes, so the executor builds the step's
run plan once (Executor.compile_count).

Speculation and the prefix cache keep it: a sampled token at index t
is one keyed function of (seed, t, prefix) whichever path emitted it
(decode_cache.spec_token_keyed), and a prefix hit resumes at a chunk
boundary of the cold schedule.

The constructor takes the reference's parameters in the reference's
order.  `cache_dtype` "bfloat16" keeps every KV pool in bf16 (the
target's, the draft's and the prefix banks), half the bytes of float32
(kv_pool_bytes): the attention kernels read the bf16 keys and values
widened beside a float32 query.  Not ported yet, each raising
NotImplementedError when set: weight-only int8 (`quantize_int8`) and
tensor-parallel pools (`mesh`), ROADMAP A5; the pools' sharding
(`partition_rules`, `mp_axis`), A7.
"""

import time

import numpy as np

from ..profiler import RecordEvent
from .pool import DECODE, PREFILL

__all__ = ["ServingEngine", "serve_one_at_a_time"]


def _accept_rate(accepted, proposed):
    """The solo loops' convention: no proposal (speculation off, a
    request that only prefilled) reads 1.0."""
    return (accepted / proposed) if proposed else 1.0


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
                (quantize_int8, "quantize_int8 (weight-only int8 serving)",
                 "A5"),
                (mesh, "mesh (tensor-parallel pools)", "A5"),
                (partition_rules, "partition_rules (tensor-parallel pools)",
                 "A7"),
                (mp_axis, "mp_axis (tensor-parallel pools)", "A7")):
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
        self.cache_dtype = str(cache_dtype)
        (self.step_main, self.cache_startup, self._feeds, self.step_fetch,
         self.cache_names) = gpt2.gpt2_ragged_step_program(
            hp, batch=self.n_slots, t_max=self.t_max, width=self.width,
            cache_dtype=cache_dtype)
        dh = hp.d_model // hp.n_head
        n_kv = getattr(hp, "n_kv_head", None) or hp.n_head
        self.reset_prog = make_slot_reset_program(
            [(n, (self.n_slots, n_kv, self.t_max, dh))
             for n in self.cache_names],
            self.n_slots, dtype=cache_dtype)
        # ---- in-pool speculative decoding ----------------------------
        # draft="self" runs the target's own ragged step over a second KV
        # pool in the same scope (cache_prefix renames its persistables);
        # draft=(draft_hp, draft_scope) a smaller model with its weights
        # and caches in its own Scope, over the same slot layout.  Either
        # way the draft program's feeds are the target's, so the pooled
        # feed drives both and admit / reset / evict cover the draft pool
        self.draft_hp = None
        self.draft_scope = None
        self.spec_k = 0
        if draft is not None:
            if isinstance(draft, str):
                assert draft == "self", draft
                self.draft_hp, self.draft_scope = hp, None
                dprefix = "gpt2sd"
            else:
                self.draft_hp, self.draft_scope = draft
                dprefix = "gpt2"
            self.spec_k = int(spec_k or min(4, self.width))
            assert 2 <= self.spec_k <= self.width, (
                "spec_k must be in [2, width]", self.spec_k, self.width)
            assert self.draft_hp.n_ctx >= self.t_max, (
                self.draft_hp.n_ctx, self.t_max)
            (self.draft_main, self.draft_startup, _, self.draft_fetch,
             self.draft_cache_names) = gpt2.gpt2_ragged_step_program(
                self.draft_hp, batch=self.n_slots, t_max=self.t_max,
                width=self.width, cache_dtype=cache_dtype,
                cache_prefix=dprefix)
            dn_kv = (getattr(self.draft_hp, "n_kv_head", None)
                     or self.draft_hp.n_head)
            ddh = self.draft_hp.d_model // self.draft_hp.n_head
            self._draft_slot_shape = (self.n_slots, dn_kv, self.t_max, ddh)
            self.draft_reset = make_slot_reset_program(
                [(n, self._draft_slot_shape)
                 for n in self.draft_cache_names],
                self.n_slots, dtype=cache_dtype)
        # ---- prefix-cache KV reuse -----------------------------------
        # a pool of rows holding registered prompt prefixes; admission
        # longest-matches on token ids and the load program copies the
        # matched KV into the slot, so prefill starts at the boundary.
        # The chunk is a multiple of the width, so a resumed prefill
        # replays the cold chunk schedule.  A speculative engine mirrors
        # every row in a draft bank: the draft's distribution must resume
        # exactly too, or sampled accept / reject draws fork a hit's
        # stream from the cold one
        self.prefix = None
        self.prefix_chunk = 0
        if prefix_rows:
            from .prefix import PrefixCache

            chunk = int(prefix_chunk or self.width)
            assert chunk % self.width == 0, (chunk, self.width)
            self.prefix = PrefixCache(int(prefix_rows), chunk)
            self.prefix_chunk = chunk
            self.prefix.add_bank(
                self.cache_names, (self.n_slots, n_kv, self.t_max, dh),
                cache_dtype, tag="target")
            if self.spec_k:
                self.prefix.add_bank(
                    self.draft_cache_names, self._draft_slot_shape,
                    cache_dtype, tag="draft", scope=self.draft_scope)
            # zero the prefix pools once: registered rows outlive a
            # serving episode (run() zeroes only the slot pools)
            self.prefix.startup(self.exe)
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
                         "rejected": 0, "expired": 0, "prefill_chunks": 0,
                         "draft_steps": 0, "spec_rounds": 0,
                         "spec_proposed": 0, "spec_accepted": 0,
                         "prefix_hits": 0, "prefix_misses": 0,
                         "prefix_tokens_reused": 0}
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
            "prefix_len": getattr(slot_state, "prefix_len", 0),
            "spec_proposed": getattr(slot_state, "spec_proposed", 0),
            "spec_accepted": getattr(slot_state, "spec_accepted", 0),
            "accept_rate": _accept_rate(
                getattr(slot_state, "spec_accepted", 0),
                getattr(slot_state, "spec_proposed", 0)),
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
            loads = {}  # slot -> prefix row (this wave's prefix hits)
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
                    pfx_row, pfx_len = (None, 0)
                    if self.prefix is not None:
                        pfx_row, pfx_len = self.prefix.match(req.prompt)
                    slot = self.pool.admit(req, self.now,
                                           prefix_len=pfx_len)
                    keep[slot] = 0.0
                    admitted = True
                    self.counters["admitted"] += 1
                    if pfx_row is not None:
                        loads[slot] = pfx_row
                        self.prefix.touch(pfx_row, pfx_len)
                        self.counters["prefix_hits"] += 1
                        self.counters["prefix_tokens_reused"] += pfx_len
                    elif self.prefix is not None:
                        self.prefix.miss()
                        self.counters["prefix_misses"] += 1
                elif self.queue_depth is None or waiting < self.queue_depth:
                    waiting += 1
                    still.append(req)
                else:
                    self._terminal(req, "REJECTED_QUEUE_FULL")
                    terminal.append(req.rid)
            self.queue = still
            if admitted:
                # zero exactly the admitted slots' cache rows, the draft
                # pool's in lockstep (the same mask)
                self.exe.run(self.reset_prog, feed={"slot_keep": keep},
                             fetch_list=[])
                if self.spec_k:
                    self.exe.run(self.draft_reset,
                                 feed={"slot_keep": keep}, fetch_list=[],
                                 scope=self.draft_scope)
                if loads:
                    # prefix hits: copy the matched KV rows into the
                    # slots just reset (target and draft banks)
                    self.prefix.load(self.exe, loads)
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
        # the speculative round: the draft proposes k_s tokens for each
        # decoding slot (its first dispatch runs the pooled feed as
        # built, so prompt chunks prefill the draft's cache in lockstep),
        # then the spec rows of the one target dispatch widen to the
        # anchor and the drafts: feed values change, shapes never
        spec, drafts, daux, draft_due = [], {}, {}, None
        if self.spec_k:
            with RecordEvent("serve_draft", cat="draft"):
                spec, drafts, daux, draft_due = self._draft_round(feed, plan)
            for slot, k_s in spec:
                feed["step_ids"][slot, 1:1 + k_s] = drafts[slot]
                feed["width_rows"][slot] = 1 + k_s
        with RecordEvent("serve_step", cat=phase):
            (logits,) = self.exe.run(self.step_main, feed=feed,
                                     fetch_list=self.step_fetch)
        finished = []
        with RecordEvent("serve_sample", cat="sample"):
            due = {slot for slot, _ in plan}
            for slot, s in active:
                if slot not in due:
                    self.pool.advance_prefill(slot)
            spec_set = {slot for slot, _ in spec}
            plain = [(slot, col) for slot, col in plan
                     if slot not in spec_set]
            if plain:
                rows = np.stack([logits[slot, col] for slot, col in plain])
                drows = (np.stack([draft_due[slot] for slot, _ in plain])
                         if draft_due is not None else None)
                toks = self._pick_tokens(rows, [s for s, _ in plain],
                                         draft_rows=drows)
                for (slot, _), tok in zip(plain, toks):
                    s = self.pool.slots[slot]
                    self.counters["new_tokens"] += 1
                    if self.pool.advance(slot, tok):
                        self._finish(slot)
                        finished.append(s.req.rid)
            for slot, k_s in spec:
                s = self.pool.slots[slot]
                emit, accepted = self._resolve_spec_row(
                    s, logits[slot], drafts[slot], daux.get(slot), k_s)
                self.counters["spec_rounds"] += 1
                self.counters["spec_proposed"] += k_s
                self.counters["spec_accepted"] += accepted
                s.spec_proposed += k_s
                s.spec_accepted += accepted
                for tok in emit:
                    self.counters["new_tokens"] += 1
                    if self.pool.advance(slot, tok):
                        # budget or EOS inside the round: the later tokens
                        # go (a solo run would never have emitted them)
                        self._finish(slot)
                        finished.append(s.req.rid)
                        break
        self.step_seconds.append(time.perf_counter() - t0)
        self.counters["steps"] += 1
        self.counters["occupancy_sum"] += len(active) / self.n_slots
        self.now += 1
        return terminal + finished

    # ---- the speculative round -----------------------------------------
    def _spec_eligible(self, slot, s):
        """How many tokens the draft may propose for this slot this
        round: spec_k - 1, capped by the budget left (a round emits at
        most k_s + 1 tokens) and by the cache (the verify row writes the
        anchor and the drafts at pos..pos+k_s; the tail falls back to
        one-token steps, the solo loops' capacity rule)."""
        if s.state != DECODE:
            return 0
        remaining = s.req.max_new_tokens - len(s.out)
        return max(0, min(self.spec_k - 1, remaining - 1,
                          self.t_max - s.pos - 1))

    def _run_draft(self, feed):
        self.counters["draft_steps"] += 1
        dfeed = dict(feed)
        # the draft's position table may be shorter than the target's:
        # clip the (never read) columns past the row's width into it
        dfeed["pos_mat"] = np.minimum(feed["pos_mat"],
                                      self.draft_hp.n_ctx - 1)
        (dl,) = self.exe.run(self.draft_main, feed=dfeed,
                             fetch_list=self.draft_fetch,
                             scope=self.draft_scope)
        return dl

    def _draft_pick(self, s, pd_row, token_index):
        """One draft proposal: a greedy row's argmax; a sampled row draws
        from the filtered draft row with the keyed draft stream at the
        global token index (the resolver and any replay re-derive it)."""
        from ..models.decode_cache import spec_propose_keyed

        if s.req.greedy:
            return int(pd_row.argmax())
        return spec_propose_keyed(pd_row, s.req.seed, token_index)

    def _filtered_row(self, s, logits_row):
        from ..models.decode_cache import filtered_probs_rows

        return filtered_probs_rows(
            np.asarray(logits_row)[None, :], [s.req.temperature],
            [s.req.top_k], [s.req.top_p])[0]

    def _draft_round(self, feed, plan):
        """The step's draft phase.  Dispatch 1 runs the pooled feed as
        built through the draft program: prompt chunks prefill the draft
        cache in lockstep with the target's, and every decoding slot's
        anchor keeps the draft cache current.  Eligible slots then draft
        k_s - 1 more tokens a dispatch at a time (max k_s dispatches in
        all, feed values only).  Returns (spec rows [(slot, k_s)],
        drafts {slot: [token]}, daux {slot: [filtered draft rows]} of
        sampled slots, draft_due {slot: the raw draft logits row} of the
        plan's due rows: the keyed rule needs the draft's distribution
        on plain-decode and prefill-finishing rows too)."""
        active = self.pool.active_slots()
        spec = [(slot, k) for slot, s in active
                for k in (self._spec_eligible(slot, s),) if k >= 1]
        dl = self._run_draft(feed)
        draft_due = {slot: dl[slot, col] for slot, col in plan}
        drafts, daux = {}, {}
        live = []
        for slot, k_s in spec:
            s = self.pool.slots[slot]
            base = len(s.out) + s.req.sample_step_base
            pd = (None if s.req.greedy
                  else self._filtered_row(s, dl[slot, 0]))
            raw = dl[slot, 0] if s.req.greedy else pd
            drafts[slot] = [self._draft_pick(s, raw, base)]
            daux[slot] = [pd]
            live.append((slot, k_s, base))
        max_k = max((k for _, k in spec), default=0)
        b, w = self.n_slots, self.width
        for j in range(1, max_k):
            ids = np.zeros((b, w), "int64")
            pos_rows = np.zeros(b, "int64")
            width_rows = np.zeros(b, "int64")
            rows = [(slot, k_s, base) for slot, k_s, base in live
                    if k_s > j]
            if not rows:
                break
            for slot, k_s, base in rows:
                ids[slot, 0] = drafts[slot][-1]
                pos_rows[slot] = self.pool.slots[slot].pos + j
                width_rows[slot] = 1
            pos_mat = np.clip(
                pos_rows[:, None] + np.arange(w, dtype="int64")[None, :],
                0, self.hp.n_ctx - 1)
            dl = self._run_draft({"step_ids": ids, "pos_rows": pos_rows,
                                  "width_rows": width_rows,
                                  "pos_mat": pos_mat})
            for slot, k_s, base in rows:
                s = self.pool.slots[slot]
                pd = (None if s.req.greedy
                      else self._filtered_row(s, dl[slot, 0]))
                raw = dl[slot, 0] if s.req.greedy else pd
                drafts[slot].append(self._draft_pick(s, raw, base + j))
                daux[slot].append(pd)
        return spec, drafts, daux, draft_due

    def _resolve_spec_row(self, s, logits_row, d_list, pd_list, k_s):
        """Resolve one slot's verify row: logits_row [W, vocab] of the
        widened target dispatch, columns 0..k_s scoring the anchor and
        the drafts.  Greedy: the solo loops' rule
        (decode_cache.greedy_accept_len), the longest prefix of drafts
        equal to the argmax, then the bonus or correction column — the
        plain argmax chain's tokens.  Sampled: keyed rejection sampling
        per index (decode_cache.spec_accept_keyed); the first rejection
        emits the residual's draw and stops; no bonus on full acceptance
        (it has no draft proposal, so the token at its index would
        depend on the rounds and break solo equality).  Rollback costs
        nothing: pool.advance moves `pos` over emitted tokens only, and
        rejected drafts' K/V lie beyond it, masked until overwritten.
        Returns (emitted tokens, accepted draft count)."""
        from ..models.decode_cache import (greedy_accept_len,
                                           spec_accept_keyed)

        r = s.req
        if r.greedy:
            tgt_next = np.asarray(logits_row[:k_s + 1]).argmax(-1)
            tgt_next = tgt_next.astype("int64")[None, :]
            j = greedy_accept_len(
                tgt_next, [np.asarray([d], "int64") for d in d_list])
            return d_list[:j] + [int(tgt_next[0, j])], j
        base = len(s.out) + r.sample_step_base
        emit, accepted = [], 0
        for jj in range(k_s):
            pt = self._filtered_row(s, logits_row[jj])
            tok, ok = spec_accept_keyed(
                d_list[jj], pt, pd_list[jj], r.seed, base + jj)
            emit.append(tok)
            if not ok:
                break
            accepted += 1
        return emit, accepted

    def _pick_tokens(self, rows, slots, draft_rows=None):
        """Per-row token selection with per-request params: greedy rows
        argmax, sampled rows draw from their filtered row with the keyed
        fold_in(seed, request_step) stream — a pure function of
        (request, step), neighbours invisible.  draft_rows (a speculative
        engine): the matching raw draft logits rows; sampled rows then
        take the keyed propose / accept / residual rule the round's
        resolver takes, so a request's token at index t is one function
        of (seed, t, prefix) whether a verify round, the first token
        after prefill or a capacity-tail step emitted it."""
        from ..models.decode_cache import (filtered_probs_rows,
                                           sample_rows_keyed,
                                           spec_token_keyed)

        rows = np.asarray(rows)
        sl = [self.pool.slots[s] for s in slots]
        greedy = np.array([s.req.greedy for s in sl], bool)
        out = np.zeros(len(slots), "int64")
        if greedy.any():
            out[greedy] = rows[greedy].argmax(axis=-1)
        samp = np.nonzero(~greedy)[0]
        if samp.size:
            ss = [sl[j] for j in samp]
            params = ([s.req.temperature for s in ss],
                      [s.req.top_k for s in ss], [s.req.top_p for s in ss])
            probs = filtered_probs_rows(rows[samp], *params)
            steps = [len(s.out) + s.req.sample_step_base for s in ss]
            if draft_rows is None:
                out[samp] = sample_rows_keyed(
                    probs, [s.req.seed for s in ss], steps)
            else:
                pds = filtered_probs_rows(np.asarray(draft_rows)[samp],
                                          *params)
                for i, s in enumerate(ss):
                    tok, ok = spec_token_keyed(probs[i], pds[i], s.req.seed,
                                               steps[i])
                    out[samp[i]] = tok
                    self.counters["spec_proposed"] += 1
                    self.counters["spec_accepted"] += int(ok)
                    s.spec_proposed += 1
                    s.spec_accepted += int(ok)
        return out

    def _finish(self, slot):
        s = self.pool.evict(slot)
        self.counters["finished"] += 1
        self._results[s.req.rid] = self._result(s.req, "OK", s)

    # ---- result serialization (out-of-process pools) -------------------
    @staticmethod
    def wire_result(r):
        """One terminal result coerced onto the RPC wire's closed type
        system: tokens stay an int64 ndarray, every scalar becomes a plain
        int / float / str / bool / None (a stray np.int64 would fail the
        codec), and the statuses cross unchanged."""

        def _scalar(v):
            if v is None or isinstance(v, (str, bool)):
                return v
            if isinstance(v, (int, np.integer)):
                return int(v)
            return float(v)

        out = {}
        for k, v in r.items():
            if k == "tokens":
                out[k] = np.asarray(v, "int64")
            else:
                out[k] = _scalar(v)
        return out

    def wire_results(self, rids=None):
        """Terminal results for `rids` (default: all) as wire-safe dicts,
        each tagged with its "rid"."""
        keys = self._results.keys() if rids is None else rids
        out = []
        for rid in keys:
            r = self.wire_result(self._results[rid])
            r["rid"] = rid
            out.append(r)
        return out

    # ---- pool placement ------------------------------------------------
    def kv_pool_bytes(self, scope=None):
        """Where the KV slot pool lives: its total bytes, the bytes on
        each device ("cuda:0", "cpu"), and their largest.  Call after a
        run (the caches must be in the scope)."""
        from ..core.scope import global_scope

        scope = scope or global_scope()
        total = 0
        per_dev = {}
        for n in self.cache_names:
            t = scope.find_var(n)
            if t is None:
                raise RuntimeError(
                    "kv_pool_bytes: cache %r not in scope — run the "
                    "engine (or its cache startup) first" % n)
            nbytes = t.numel() * t.element_size()
            total += nbytes
            d = str(t.device)
            per_dev[d] = per_dev.get(d, 0) + nbytes
        return {"total_bytes": total, "per_device_bytes": per_dev,
                "max_device_bytes": max(per_dev.values()) if per_dev else 0}

    # ---- prefix registration -------------------------------------------
    def register_prefix(self, tokens):
        """Make the KV of a common prompt prefix resident: prefill slot 0
        with `tokens` (chunk-floored) through the serving step programs
        (the target's and, on a speculative engine, the draft's, so both
        banks hold exactly what a cold prefill writes), then copy slot
        0's rows into a prefix row with the store program.  The engine
        must be idle (registration borrows slot 0).  Returns the prefix
        row, or None when `tokens` are shorter than one chunk.  The same
        tokens again dedup to their resident row without a prefill."""
        if self.prefix is None:
            raise RuntimeError("engine built without prefix_rows")
        if self.queue or self.pool.active_slots():
            raise RuntimeError("register_prefix on a busy engine")
        tokens = np.asarray(tokens, "int64").reshape(-1)
        ln = (int(tokens.size) // self.prefix_chunk) * self.prefix_chunk
        if ln < self.prefix_chunk:
            return None
        tokens = tokens[:ln]
        row, fresh = self.prefix.assign(tokens)
        if not fresh:
            return row
        # the whole cache startups (the engine is idle, and registration
        # may precede the first run(): the slot pools must exist before
        # the copy programs touch them)
        self.exe.run(self.cache_startup)
        if self.spec_k:
            self.exe.run(self.draft_startup, scope=self.draft_scope)
        b, w = self.n_slots, self.width
        for c0 in range(0, ln, w):
            chunk = tokens[c0:c0 + w]
            ids = np.zeros((b, w), "int64")
            ids[0, :chunk.size] = chunk
            pos_rows = np.zeros(b, "int64")
            pos_rows[0] = c0
            width_rows = np.zeros(b, "int64")
            width_rows[0] = chunk.size
            pos_mat = np.clip(
                pos_rows[:, None] + np.arange(w, dtype="int64")[None, :],
                0, self.hp.n_ctx - 1)
            feed = {"step_ids": ids, "pos_rows": pos_rows,
                    "width_rows": width_rows, "pos_mat": pos_mat}
            # fetch the (discarded) logits: the serving step's own cache
            # entry, not a second one without the fetch
            self.exe.run(self.step_main, feed=feed,
                         fetch_list=self.step_fetch)
            if self.spec_k:
                self._run_draft(feed)
        self.prefix.store(self.exe, row, slot=0)
        return row

    def observe_prefixes(self, requests, min_count=2):
        """Register the chunk-floored prompt prefixes that at least
        `min_count` of `requests` share (grouped by their first chunk,
        the longest common prefix of each group).  Host analysis, then
        register_prefix: run it while the engine is idle.  Returns the
        registered rows."""
        if self.prefix is None:
            raise RuntimeError("engine built without prefix_rows")
        chunk = self.prefix_chunk
        groups = {}
        for r in requests:
            p = np.asarray(r.prompt, "int64").reshape(-1)
            if p.size - 1 < chunk:
                continue
            groups.setdefault(tuple(p[:chunk].tolist()), []).append(p)
        rows = []
        for ps in groups.values():
            if len(ps) < min_count:
                continue
            base = ps[0]
            lcp = min(int(q.size) for q in ps)
            for q in ps[1:]:
                n = min(lcp, int(base.size), int(q.size))
                eq = base[:n] == q[:n]
                lcp = n if eq.all() else int(np.argmax(~eq))
            ln = (lcp // chunk) * chunk
            if ln >= chunk:
                row = self.register_prefix(base[:ln])
                if row is not None:
                    rows.append(row)
        return rows

    # ---- control-plane snapshot ----------------------------------------
    def stats(self):
        """Counters snapshot (the shape the reference's `stats` verb
        surfaces per pool), with the acceptance rate and the prefix
        cache's counters."""
        c = dict(self.counters)
        c["compile_count"] = int(self.exe.compile_count)
        c["accept_rate"] = _accept_rate(c["spec_accepted"],
                                        c["spec_proposed"])
        c["spec_on"] = bool(self.spec_k)
        c["spec_k"] = int(self.spec_k)
        if self.prefix is not None:
            c["prefix_hit_rate"] = (
                c["prefix_hits"]
                / max(1, c["prefix_hits"] + c["prefix_misses"]))
            c.update(self.prefix.counters())
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
        if self.spec_k:
            self.exe.run(self.draft_startup, scope=self.draft_scope)
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
            "accept_rate": _accept_rate(c["spec_accepted"],
                                        c["spec_proposed"]),
            "prefix_hit_rate": (c["prefix_hits"]
                                / max(1, c["prefix_hits"]
                                      + c["prefix_misses"])
                                if self.prefix is not None else 0.0),
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
