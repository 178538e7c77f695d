"""Prefix-cache KV reuse for the serving engine (the counterpart of
``paddle_tpu/serving/prefix.py``): a pool of KV rows holding registered
common prompt prefixes (system prompts, few-shot templates), and the
programs that copy whole cache rows between that pool and the slot pool.

- The pool holds R rows per cache persistable, named ``pfx_<cache>``
  ([R, n_kv, t_max, dh]: the slot pool's shape with R rows).
- Matching runs on the host, on token ids: the longest common prefix of
  a request's prompt and each registered row, floored to a multiple of
  ``chunk`` and capped at prompt_len - 1 (at least one prompt token goes
  through prefill to give the first logits).  The floor is what makes a
  hit's stream bit-identical to a cold one: the engine prefills in
  width-W chunks from position 0, so resuming at a multiple of W replays
  the chunk schedule a cold run uses from that boundary on.
- Copying runs on the device, one program per direction
  (``decode_cache.make_row_copy_program``): load = prefix rows -> the
  admitted slots' rows, store = a freshly prefilled slot's rows -> a
  prefix row.  Row ids and masks are feeds, so every assignment reuses
  the one captured step.
- A speculative engine adds a second bank over the draft's caches: with
  speculation, sampling and the prefix cache all on, the draft's
  distribution must resume exactly too, or the accept / reject draws
  fork a hit's stream from the cold one.

Rows are replaced by registration (the same tokens dedup to their row;
new tokens evict the least recently matched row when the pool is
full).  A weight change invalidates every row: call ``invalidate()``
(the host index is dropped; the stale rows are never matched again and
are overwritten by later registrations).
"""

import numpy as np

__all__ = ["PrefixCache"]


class _Bank:
    """One cache family's copy programs (the target's, the draft's)."""

    __slots__ = ("load_prog", "store_prog", "startup", "scope", "tag")

    def __init__(self, load_prog, store_prog, startup, scope, tag):
        self.load_prog = load_prog
        self.store_prog = store_prog
        self.startup = startup
        self.scope = scope
        self.tag = tag


class PrefixCache:
    """The host index and the copy programs of prefix KV reuse.

    rows:  how many registered prefixes are resident at once
    chunk: the match granularity, a multiple of the engine's width W
           (the engine checks it), so that a resumed prefill replays
           the cold chunk schedule
    """

    def __init__(self, rows, chunk):
        self.rows = int(rows)
        self.chunk = int(chunk)
        assert self.rows >= 1 and self.chunk >= 1, (rows, chunk)
        self._tokens = [None] * self.rows  # int64 arrays (the host index)
        self._tick = 0
        self._last_used = [-1] * self.rows
        self._banks = []
        # lifetime counters (the engine's reset at every run; these last)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.registrations = 0
        self.evictions = 0

    # -- bank wiring (the engine's set-up) --------------------------------

    def add_bank(self, cache_names, slot_shape, dtype, tag="target",
                 scope=None):
        """Build the prefix persistables and the load / store / startup
        programs of one cache family.  cache_names: the slot pool's
        persistables ([B, n_kv, t_max, dh] each, == slot_shape); their
        prefix twins are ``pfx_<name>`` with R rows.  `scope`: the Scope
        the family lives in (None: the ambient scope, the target's and a
        self-draft's; a separate-scope draft passes its own).  Returns
        the bank (also kept)."""
        from .. import framework
        from ..models.decode_cache import (add_cache_zero_fills,
                                           make_row_copy_program)

        b = int(slot_shape[0])
        pfx_shape = [self.rows] + list(slot_shape[1:])
        startup = framework.Program()
        add_cache_zero_fills(
            startup, [("pfx_" + n, pfx_shape) for n in cache_names],
            dtype=dtype)
        load_prog = make_row_copy_program(
            [("pfx_" + n, pfx_shape, n, list(slot_shape))
             for n in cache_names], b, dtype=dtype)
        store_prog = make_row_copy_program(
            [(n, list(slot_shape), "pfx_" + n, pfx_shape)
             for n in cache_names], self.rows, dtype=dtype)
        bank = _Bank(load_prog, store_prog, startup, scope, tag)
        self._banks.append(bank)
        return bank

    @property
    def banks(self):
        return list(self._banks)

    def startup(self, exe):
        """Zero every bank's prefix pool (once, at the engine's
        construction, not at each run: registered rows outlive a
        serving episode)."""
        for bank in self._banks:
            exe.run(bank.startup, feed={}, fetch_list=[], scope=bank.scope)

    # -- host index -------------------------------------------------------

    def match(self, prompt):
        """The longest match among the registered rows: (row, L) with L a
        positive multiple of `chunk` (at most len(prompt) - 1), or
        (None, 0) on a miss.  A tie takes the lower row id."""
        prompt = np.asarray(prompt, "int64").reshape(-1)
        best_row, best_len = None, 0
        for r, toks in enumerate(self._tokens):
            if toks is None:
                continue
            n = min(int(toks.size), int(prompt.size) - 1)
            if n < self.chunk:
                continue
            eq = prompt[:n] == toks[:n]
            lcp = n if eq.all() else int(np.argmax(~eq))
            length = (lcp // self.chunk) * self.chunk
            if length > best_len:
                best_row, best_len = r, length
        if best_len >= self.chunk:
            return best_row, best_len
        return None, 0

    def touch(self, row, reused_tokens):
        """Record a hit on `row` (its recency and the counters)."""
        self._tick += 1
        self._last_used[row] = self._tick
        self.hits += 1
        self.tokens_reused += int(reused_tokens)

    def miss(self):
        self.misses += 1

    def assign(self, tokens):
        """The row for `tokens` (chunk-floored already): a resident exact
        match keeps its row ((row, False): its KV is there), else a free
        row, else the least recently used row is evicted.  Returns (row,
        fresh)."""
        tokens = np.asarray(tokens, "int64").reshape(-1)
        for r, toks in enumerate(self._tokens):
            if toks is not None and toks.size == tokens.size \
                    and bool((toks == tokens).all()):
                self._tick += 1
                self._last_used[r] = self._tick
                return r, False
        for r, toks in enumerate(self._tokens):
            if toks is None:
                row = r
                break
        else:
            row = min(range(self.rows), key=lambda r: self._last_used[r])
            self.evictions += 1
        self._tokens[row] = tokens.copy()
        self._tick += 1
        self._last_used[row] = self._tick
        self.registrations += 1
        return row, True

    def invalidate(self):
        """Drop the host index (after a weight update, say): the stale
        rows are never matched again."""
        self._tokens = [None] * self.rows
        self._last_used = [-1] * self.rows

    def registered(self):
        """The resident prefixes as {row: token array}."""
        return {r: t.copy() for r, t in enumerate(self._tokens)
                if t is not None}

    # -- device copies ----------------------------------------------------

    def load(self, exe, slot_rows):
        """Copy prefix rows into slot rows, slot_rows = {slot: prefix row}
        for this admission wave: one dispatch a bank, whatever the
        assignment (the ids and masks are feeds)."""
        if not slot_rows or not self._banks:
            return
        b = int(self._banks[0].load_prog.global_block()
                .vars["copy_take"].shape[0])
        src = np.zeros(b, "int64")
        take = np.zeros(b, "float32")
        for slot, row in slot_rows.items():
            src[slot] = row
            take[slot] = 1.0
        feed = {"copy_src_rows": src, "copy_take": take,
                "copy_keep": 1.0 - take}
        for bank in self._banks:
            exe.run(bank.load_prog, feed=feed, fetch_list=[],
                    scope=bank.scope)

    def store(self, exe, row, slot):
        """Copy slot `slot`'s freshly prefilled cache rows into prefix row
        `row` (registration), in every bank."""
        src = np.full(self.rows, int(slot), "int64")
        take = np.zeros(self.rows, "float32")
        take[row] = 1.0
        feed = {"copy_src_rows": src, "copy_take": take,
                "copy_keep": 1.0 - take}
        for bank in self._banks:
            exe.run(bank.store_prog, feed=feed, fetch_list=[],
                    scope=bank.scope)

    # -- reporting --------------------------------------------------------

    def counters(self):
        return {"prefix_lifetime_hits": self.hits,
                "prefix_lifetime_misses": self.misses,
                "prefix_lifetime_tokens_reused": self.tokens_reused,
                "prefix_registrations": self.registrations,
                "prefix_evictions": self.evictions,
                "prefix_rows": self.rows,
                "prefix_rows_used": sum(
                    1 for t in self._tokens if t is not None),
                "prefix_chunk": self.chunk}
