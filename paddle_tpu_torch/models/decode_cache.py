"""KV-cache scaffolding for incremental decode and the serving step (the
counterpart of ``paddle_tpu/models/decode_cache.py``): per-layer cache
variables, the zeroing program, the per-slot reset and beam reorder
programs, capacity probes, the prologue checks and chunk loop of the
cached generation loops, the prefix cache's row-copy program, and the
host-side numpy samplers with the speculative resolver's keyed rule.
The samplers and the resolver are copied from the reference unchanged:
they are plain numpy, and keeping them bit-identical is what lets a
request sample the same tokens through either package from the same
logits."""

import numpy as np

from .. import framework, layers

__all__ = ["create_kv_caches", "add_cache_zero_fills",
           "make_slot_reset_program", "make_row_copy_program",
           "probe_cache_len", "probe_cache_dtype",
           "make_cache_reorder_program", "validate_cached_call",
           "run_chunked_ids", "filtered_probs", "sample_rows",
           "sample_from_logits", "fold_in_seed", "sample_rows_keyed",
           "filtered_probs_rows", "greedy_accept_len", "residual_probs",
           "spec_key", "spec_propose_keyed", "spec_accept_keyed",
           "spec_token_keyed"]


def create_kv_caches(block, prefix, n_layer, batch, n_head, t_max, dh,
                     dtype="float32"):
    """Per-layer persistable [batch, n_head, t_max, dh] K/V cache vars
    named `<prefix>_{k,v}cache_<layer>`.  Returns (per-layer cache
    dicts, all names)."""
    caches, names = [], []
    for li in range(n_layer):
        cache = {}
        for nm in ("k", "v"):
            cname = "%s_%scache_%d" % (prefix, nm, li)
            cache[nm] = block.create_var(
                name=cname, shape=[batch, n_head, t_max, dh], dtype=dtype,
                persistable=True)
            names.append(cname)
        caches.append(cache)
    return caches, names


def add_cache_zero_fills(zero_program, named_shapes, dtype="float32"):
    """Append fill_constant ops zeroing each (name, shape) persistable
    into `zero_program`."""
    with framework.program_guard(zero_program, framework.Program()):
        blk = zero_program.global_block()
        for cname, shape in named_shapes:
            layers.fill_constant(
                list(shape), dtype, 0.0,
                out=blk.create_var(name=cname, shape=list(shape),
                                   dtype=dtype, persistable=True))


def make_slot_reset_program(named_shapes, batch, dtype="float32"):
    """Per-slot cache resets (the serving pool's admission step): every
    named [B, ...] cache is multiplied by the fed `slot_keep` [B] row
    mask — 1.0 keeps a slot's rows, 0.0 zeroes them.  One program covers
    every subset of slots (the mask is a feed).  named_shapes entries:
    (name, shape) or (name, shape, dtype), the entry's dtype overriding
    `dtype` (bf16 caches reset in bf16)."""
    prog = framework.Program()
    with framework.program_guard(prog, framework.Program()):
        keep = layers.data("slot_keep", shape=[batch], dtype="float32",
                           append_batch_size=False)
        blk = prog.global_block()
        for entry in named_shapes:
            cname, shape = entry[0], entry[1]
            vdtype = entry[2] if len(entry) > 2 else dtype
            assert int(shape[0]) == batch, (cname, shape, batch)
            cvar = blk.create_var(name=cname, shape=list(shape), dtype=vdtype,
                                  persistable=True)
            masked = layers.elementwise_mul(cvar, keep, axis=0)
            if str(vdtype) != "float32":
                # the float32 mask promotes the product: cast it back, so
                # a bf16 cache stays bf16 (assign does not cast)
                masked = layers.cast(masked, str(vdtype))
            blk.append_op("assign", inputs={"X": [masked]},
                          outputs={"Out": [cvar]})
    return prog


def make_row_copy_program(named_pairs, n_dst, dtype="float32"):
    """make_slot_reset_program generalized to row copies between two
    pools (the prefix cache's load and store): for every (src_name,
    src_shape, dst_name, dst_shape) pair, gather `n_dst` rows of the
    [R, ...] src persistable by the fed `copy_src_rows` ids and lerp
    them into the [n_dst, ...] dst persistable under the fed
    `copy_take` / `copy_keep` [n_dst] row masks (callers pass keep =
    1 - take; take=0 rows keep dst).  One program covers every row
    assignment: the ids and masks are feeds.  A pair may append its own
    dtype (bf16 caches copy in bf16: the float32 masks promote the
    product, a cast restores the dtype)."""
    prog = framework.Program()
    with framework.program_guard(prog, framework.Program()):
        rows = layers.data("copy_src_rows", shape=[n_dst], dtype="int64",
                           append_batch_size=False)
        take = layers.data("copy_take", shape=[n_dst], dtype="float32",
                           append_batch_size=False)
        keep = layers.data("copy_keep", shape=[n_dst], dtype="float32",
                           append_batch_size=False)
        blk = prog.global_block()
        for entry in named_pairs:
            src_name, src_shape, dst_name, dst_shape = entry[:4]
            vdtype = entry[4] if len(entry) > 4 else dtype
            assert int(dst_shape[0]) == n_dst, (dst_name, dst_shape, n_dst)
            assert list(src_shape[1:]) == list(dst_shape[1:]), (
                src_name, src_shape, dst_name, dst_shape)
            src = blk.create_var(name=src_name, shape=list(src_shape),
                                 dtype=vdtype, persistable=True)
            dst = blk.create_var(name=dst_name, shape=list(dst_shape),
                                 dtype=vdtype, persistable=True)
            g = layers.gather(src, rows)
            mixed = layers.elementwise_add(
                layers.elementwise_mul(g, take, axis=0),
                layers.elementwise_mul(dst, keep, axis=0))
            if str(vdtype) != "float32":
                mixed = layers.cast(mixed, str(vdtype))
            blk.append_op("assign", inputs={"X": [mixed]},
                          outputs={"Out": [dst]})
    return prog


def probe_cache_len(step_main, prefix):
    """The decode capacity (cache time axis) of a step program."""
    for n, v in step_main.global_block().vars.items():
        if n.startswith(prefix + "_kcache_"):
            return int(v.shape[2])
    raise ValueError("no %s_kcache_* vars in the step program" % prefix)


def probe_cache_dtype(step_main, prefix):
    """The declared cache dtype of a step program (programs sharing one
    scope's cache vars must agree)."""
    for n, v in step_main.global_block().vars.items():
        if n.startswith(prefix + "_kcache_"):
            return str(v.dtype)
    raise ValueError("no %s_kcache_* vars in the step program" % prefix)


def make_cache_reorder_program(named_shapes, batch):
    """A program that gathers every named persistable cache along its
    batch axis by the fed `parents` [batch] row ids and assigns it back:
    the beam-search cache shuffle (run with fetch_list=[]).
    named_shapes entries: (name, shape) or (name, shape, dtype)."""
    prog = framework.Program()
    with framework.program_guard(prog, framework.Program()):
        parents = layers.data("parents", shape=[batch], dtype="int64",
                              append_batch_size=False)
        blk = prog.global_block()
        for entry in named_shapes:
            cname, shape = entry[0], entry[1]
            dtype = entry[2] if len(entry) > 2 else "float32"
            cvar = blk.create_var(name=cname, shape=list(shape), dtype=dtype,
                                  persistable=True)
            g = layers.gather(cvar, parents)
            blk.append_op("assign", inputs={"X": [g]},
                          outputs={"Out": [cvar]})
    return prog


def validate_cached_call(step_main, prefix, ids_var, batch, prompt_len,
                         new_tokens, beams=1):
    """The prologue checks of every cached-decode entry point: a
    non-empty prompt, the step program's static batch, and the cache
    capacity (the last generated token is never fed back, hence the
    +1).  Returns the cache length."""
    if prompt_len < 1:
        raise ValueError("empty prompt: seed generation with at least a BOS "
                         "token")
    step_b = int(step_main.global_block().vars[ids_var].shape[0])
    if batch * beams != step_b:
        raise ValueError("prompt batch %d x beams %d != decode program's "
                         "static batch %d" % (batch, beams, step_b))
    t_cache = probe_cache_len(step_main, prefix)
    if prompt_len + new_tokens > t_cache + 1:
        raise ValueError("prompt %d + new %d exceeds cache length %d"
                         % (prompt_len, new_tokens, t_cache))
    return t_cache


def run_chunked_ids(exe, main, fetches, ids, width, t_max, ids_feed,
                    has_pos_vec):
    """The chunk loop of the width-W cached programs: yields (c0,
    chunk_logits) per dispatch.  The last chunk re-anchors to t_max - W
    when it would write past the cache (rewriting identical slots is
    idempotent) and short chunks zero-pad (pad rows' K/V land in slots
    overwritten before they are first attended; pad output rows are the
    caller's to ignore)."""
    ids = np.asarray(ids, "int64")
    _b, T = ids.shape
    width = int(width)
    starts = list(range(0, T, width)) or [0]
    if starts[-1] + width > t_max:
        starts[-1] = max(0, t_max - width)
    for c0 in starts:
        chunk = ids[:, c0:c0 + width]
        if chunk.shape[1] < width:
            chunk = np.pad(chunk, ((0, 0), (0, width - chunk.shape[1])))
        feed = {ids_feed: chunk, "pos": np.array([c0], "int64")}
        if has_pos_vec:
            feed["pos_vec"] = np.minimum(
                np.arange(c0, c0 + width, dtype="int64"), t_max - 1)
        (lg,) = exe.run(main, feed=feed, fetch_list=fetches)
        yield c0, np.asarray(lg)


# ---------------------------------------------------------------------------
# host-side samplers, copied from the reference unchanged
# ---------------------------------------------------------------------------
def filtered_probs(logits, temperature=1.0, top_k=0, top_p=1.0):
    """[B, V] -> the temperature / top-k / nucleus filtered probability
    rows."""
    lg = np.asarray(logits, np.float64) / max(temperature, 1e-6)
    if top_k:
        k_eff = min(int(top_k), lg.shape[-1])  # top_k >= vocab: no-op
        kth = np.sort(lg, axis=-1)[:, -k_eff][:, None]
        lg = np.where(lg < kth, -np.inf, lg)
    probs = np.exp(lg - lg.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    if top_p < 1.0:
        order = np.argsort(-probs, axis=-1)
        sorted_p = np.take_along_axis(probs, order, -1)
        keep_sorted = np.cumsum(sorted_p, -1) - sorted_p < top_p
        keep = np.zeros_like(probs, bool)
        np.put_along_axis(keep, order, keep_sorted, -1)
        probs = np.where(keep, probs, 0.0)
        probs /= probs.sum(-1, keepdims=True)
    return probs


def sample_rows(probs, rng):
    """Categorical draw per row of a [B, V] probability matrix."""
    return np.array([rng.choice(probs.shape[-1], p=probs[i])
                     for i in range(probs.shape[0])], "int64")


def sample_from_logits(logits, rng, temperature=1.0, top_k=0, top_p=1.0):
    """Temperature / top-k / nucleus (top-p) filtered categorical
    sampling.  logits [B, V] -> [B]."""
    return sample_rows(
        filtered_probs(logits, temperature, top_k, top_p), rng)


_SPLITMIX_GAMMA = 0x9E3779B97F4A7C15


def _splitmix64(z):
    z = (z + _SPLITMIX_GAMMA) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def fold_in_seed(seed, step):
    """Derive the 32-bit rng key for (request seed, request step) —
    deterministic, order-free, neighbor-free."""
    m64 = 0xFFFFFFFFFFFFFFFF
    z = _splitmix64(_splitmix64(int(seed) & m64)
                    ^ _splitmix64((int(step) & m64) ^ _SPLITMIX_GAMMA))
    return int(z & 0xFFFFFFFF)


def sample_rows_keyed(probs, seeds, steps):
    """Categorical draw per row where row i draws from
    RandomState(fold_in_seed(seeds[i], steps[i])) — independent of
    batch composition and slot order."""
    probs = np.asarray(probs)
    seeds = np.asarray(seeds).reshape(-1)
    steps = np.asarray(steps).reshape(-1)
    out = np.empty(probs.shape[0], "int64")
    for i in range(probs.shape[0]):
        rng = np.random.RandomState(fold_in_seed(seeds[i], steps[i]))
        out[i] = rng.choice(probs.shape[-1], p=probs[i])
    return out


def filtered_probs_rows(logits, temperatures, top_ks, top_ps):
    """filtered_probs with PER-ROW sampling params, vectorized; every
    row's output is bit-identical to
    ``filtered_probs(logits[i:i+1], t[i], k[i], p[i])``."""
    lg = np.asarray(logits, np.float64).copy()
    n, v = lg.shape
    t = np.array([max(float(x), 1e-6) for x in temperatures], np.float64)
    lg /= t[:, None]
    ks = np.array([int(x) for x in top_ks])
    kr = np.nonzero(ks)[0]
    if kr.size:
        k_eff = np.minimum(ks[kr], v)  # top_k >= vocab: no-op
        srt = np.sort(lg[kr], axis=-1)
        kth = np.take_along_axis(srt, (v - k_eff)[:, None], -1)
        lg[kr] = np.where(lg[kr] < kth, -np.inf, lg[kr])
    probs = np.exp(lg - lg.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ps = np.array([float(x) for x in top_ps], np.float64)
    pr = np.nonzero(ps < 1.0)[0]
    if pr.size:
        sub = probs[pr]
        order = np.argsort(-sub, axis=-1)
        sorted_p = np.take_along_axis(sub, order, -1)
        keep_sorted = np.cumsum(sorted_p, -1) - sorted_p < ps[pr][:, None]
        keep = np.zeros_like(sub, bool)
        np.put_along_axis(keep, order, keep_sorted, -1)
        sub = np.where(keep, sub, 0.0)
        sub /= sub.sum(-1, keepdims=True)
        probs[pr] = sub
    return probs


# ---------------------------------------------------------------------------
# the speculative resolver's rule (solo loops and the serving engine),
# copied from the reference unchanged
# ---------------------------------------------------------------------------
# The keyed accept rule is the pooled twin of solo rejection sampling:
# every sub-draw (draft proposal, accept uniform, residual pick) is keyed
# by (request seed, stream tag, global token index), so the token emitted
# at index t is a pure function of (seed, t, token prefix), whatever the
# round boundaries, the batch neighbours or the admission order.  A fully
# accepted sampled round emits no bonus token (the bonus has no draft
# proposal, so it would leak round structure into the stream).  Greedy
# keeps its bonus: argmax is already prefix-pure.

_SPEC_TAG_DRAFT = 0x5D01
_SPEC_TAG_ACCEPT = 0x5D02
_SPEC_TAG_RESID = 0x5D03


def greedy_accept_len(tgt_next, drafts):
    """Longest prefix j such that every batch row's draft token equals
    the target argmax at every position < j.  tgt_next [B, K] int64,
    drafts: list of [B] arrays (may be shorter than K)."""
    j = 0
    while j < len(drafts) and bool((drafts[j] == tgt_next[:, j]).all()):
        j += 1
    return j


def residual_probs(pt, pd):
    """The rejection-sampling residual normalize(max(pt - pd, 0)) per
    row ([..., V] in, same shape out); degenerate rows (pt <= pd
    everywhere, residual mass ~0) fall back to pt."""
    resid = np.maximum(np.asarray(pt, np.float64)
                       - np.asarray(pd, np.float64), 0.0)
    rs = resid.sum(-1, keepdims=True)
    return np.where(rs > 1e-12, resid / np.maximum(rs, 1e-12), pt)


def spec_key(seed, tag, step):
    """Key of one speculative sub-draw at global token index `step`: a
    fold_in_seed stream per tag, so the three draws at one index are
    independent and none collides with the plain sampler's
    fold_in_seed(seed, step)."""
    return fold_in_seed(fold_in_seed(seed, tag), step)


def spec_propose_keyed(pd_row, seed, step):
    """The draft proposal at global token index `step`: one categorical
    draw from the filtered draft row, keyed."""
    rng = np.random.RandomState(spec_key(seed, _SPEC_TAG_DRAFT, step))
    return int(rng.choice(pd_row.shape[-1], p=pd_row))


def spec_accept_keyed(d, pt_row, pd_row, seed, step):
    """Resolve proposal `d` at global token index `step` against the
    filtered target row: accept with probability min(1, pt[d]/pd[d]),
    else draw the residual.  Returns (token, accepted); the token's
    distribution is exactly the target row's."""
    u = np.random.RandomState(
        spec_key(seed, _SPEC_TAG_ACCEPT, step)).rand()
    ratio = float(pt_row[d]) / max(float(pd_row[d]), 1e-12)
    if u <= ratio:
        return int(d), True
    resid = residual_probs(pt_row[None, :], pd_row[None, :])[0]
    rng = np.random.RandomState(spec_key(seed, _SPEC_TAG_RESID, step))
    return int(rng.choice(resid.shape[-1], p=resid)), False


def spec_token_keyed(pt_row, pd_row, seed, step):
    """Propose and resolve in one call: the per-index rule where no round
    is running (the first token after prefill, a capacity-tail step).
    The same composition as a round's propose-then-accept, so a stream
    never forks on the path that emitted a token."""
    d = spec_propose_keyed(pd_row, seed, step)
    return spec_accept_keyed(d, pt_row, pd_row, seed, step)
