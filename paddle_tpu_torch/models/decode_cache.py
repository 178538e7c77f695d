"""KV-cache scaffolding for the serving step (the counterpart of
``paddle_tpu/models/decode_cache.py``): per-layer cache variables, the
zeroing program, the per-slot reset program, and the host-side numpy
samplers.  The samplers are copied from the reference unchanged: they
are plain numpy, and keeping them bit-identical is what lets a request
sample the same tokens through either package from the same logits."""

import numpy as np

from .. import framework, layers

__all__ = ["create_kv_caches", "add_cache_zero_fills",
           "make_slot_reset_program", "fold_in_seed", "sample_rows_keyed",
           "filtered_probs", "filtered_probs_rows"]


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
    every subset of slots (the mask is a feed)."""
    prog = framework.Program()
    with framework.program_guard(prog, framework.Program()):
        keep = layers.data("slot_keep", shape=[batch], dtype="float32",
                           append_batch_size=False)
        blk = prog.global_block()
        for entry in named_shapes:
            cname, shape = entry[0], entry[1]
            vdtype = entry[2] if len(entry) > 2 else dtype
            assert int(shape[0]) == batch, (cname, shape, batch)
            if str(vdtype) != "float32":
                raise NotImplementedError(
                    "only float32 KV caches are ported (the kernels take "
                    "float32; bf16 forms are on ROADMAP)")
            cvar = blk.create_var(name=cname, shape=list(shape), dtype=vdtype,
                                  persistable=True)
            masked = layers.elementwise_mul(cvar, keep, axis=0)
            blk.append_op("assign", inputs={"X": [masked]},
                          outputs={"Out": [cvar]})
    return prog


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
