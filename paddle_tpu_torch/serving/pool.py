"""Slot pool for the continuous-batching engine (the port's copy of
``paddle_tpu/serving/pool.py``, without the prefix-cache and speculative
decoding fields, which are not ported yet): per-slot request lifecycle
(PREFILL -> DECODE -> done) and the per-step ragged feed.

The pool owns NO device state — the KV caches are the step program's
persistable vars; the pool only tracks which cache ROWS belong to which
request and at what position, and lays each step's work out as the
ragged step program's feed vectors (per-slot pos/width/ids).  A slot's
schedule is a pure function of its request (prompt length, budget):
prefill chunks of the program width W starting at 0, W, 2W, ... then
one-token decode — identical whether the request runs solo or shares
the pool, which is what the exactness contract leans on.
"""

import numpy as np

__all__ = ["SlotPool", "PREFILL", "DECODE"]

PREFILL = "prefill"
DECODE = "decode"


class _Slot:
    __slots__ = ("req", "state", "prefill_pos", "pos", "last_token",
                 "out", "admit_step")

    def __init__(self, req, admit_step):
        self.req = req
        self.state = PREFILL
        self.prefill_pos = 0     # next prompt chunk starts here
        self.pos = 0             # tokens currently resident in the cache
        self.last_token = None   # decode input for the next step
        self.out = []            # generated tokens (int)
        self.admit_step = admit_step


class SlotPool:
    def __init__(self, n_slots, width, t_max):
        self.n_slots = int(n_slots)
        self.width = int(width)
        self.t_max = int(t_max)
        self.slots = [None] * self.n_slots

    # ---- occupancy ----------------------------------------------------
    def free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_slots(self):
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    # ---- lifecycle ----------------------------------------------------
    def validate(self, req):
        """The pool's capacity rule (it owns t_max): the last generated
        token is never fed back, hence the +1 — the single source of
        truth for engine.submit and admit."""
        if req.prompt.size + req.max_new_tokens > self.t_max + 1:
            raise ValueError(
                "request %r: prompt %d + new %d exceeds pool capacity %d"
                % (req.rid, req.prompt.size, req.max_new_tokens,
                   self.t_max))

    def admit(self, req, admit_step):
        """Place `req` in a free slot; returns the slot index (caller
        zero-resets that slot's cache rows before the next dispatch)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("admit with no free slot")
        self.validate(req)
        slot = free[0]
        self.slots[slot] = _Slot(req, admit_step)
        return slot

    def evict(self, slot):
        s = self.slots[slot]
        self.slots[slot] = None
        return s

    # ---- the ragged step feed -----------------------------------------
    def build_feed(self, n_ctx):
        """Lay the current occupancy out as the ragged step program's
        feed: step_ids [B, W], pos_rows/width_rows [B], pos_mat [B, W]
        (positions clipped into the position table; clipped columns are
        never written or read).  Free slots ride along as width-0 rows.
        Returns (feed dict, sample_plan) where sample_plan lists
        (slot, logits_column) for every row that must emit a token after
        this dispatch — a decoding slot's column 0, or a prefilling
        slot's final-prompt column when this chunk completes the
        prompt."""
        b, w = self.n_slots, self.width
        ids = np.zeros((b, w), "int64")
        pos_rows = np.zeros(b, "int64")
        width_rows = np.zeros(b, "int64")
        plan = []
        for i, s in self.active_slots():
            if s.state == PREFILL:
                c0 = s.prefill_pos
                chunk = s.req.prompt[c0:c0 + w]
                ids[i, :chunk.size] = chunk
                pos_rows[i] = c0
                width_rows[i] = chunk.size
                if c0 + chunk.size >= s.req.prompt.size:
                    # this chunk finishes the prompt: its last real
                    # column's logits predict position P and emit the
                    # request's first token
                    plan.append((i, s.req.prompt.size - 1 - c0))
            else:
                ids[i, 0] = s.last_token
                pos_rows[i] = s.pos
                width_rows[i] = 1
                plan.append((i, 0))
        pos_mat = np.clip(
            pos_rows[:, None] + np.arange(w, dtype="int64")[None, :],
            0, n_ctx - 1)
        feed = {"step_ids": ids, "pos_rows": pos_rows,
                "width_rows": width_rows, "pos_mat": pos_mat}
        return feed, plan

    def any_prefilling(self):
        return any(s.state == PREFILL for _, s in self.active_slots())

    # ---- post-dispatch advance ----------------------------------------
    def advance(self, slot, token):
        """Record `token` as slot's next generated token and advance its
        lifecycle.  Returns True when the request just finished (EOS or
        budget) — the caller evicts the slot."""
        s = self.slots[slot]
        r = s.req
        if s.state == PREFILL:
            # the finishing chunk wrote the remaining prompt tokens
            s.pos = r.prompt.size
            s.state = DECODE
        else:
            s.pos += 1
        s.out.append(int(token))
        s.last_token = int(token)
        if len(s.out) >= r.max_new_tokens:
            return True
        if r.eos_id is not None and int(token) == r.eos_id:
            return True
        return False

    def advance_prefill(self, slot):
        """A non-finishing prefill chunk was dispatched: move the chunk
        cursor (cache rows c0..c0+W-1 are now resident)."""
        s = self.slots[slot]
        s.prefill_pos += self.width
        s.pos = s.prefill_pos
