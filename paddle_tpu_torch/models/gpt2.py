"""GPT-2-style decoder-only LM (the counterpart of
``paddle_tpu/models/gpt2.py``): ``GPT2Config`` (GPT-2 small by
default), ``gpt2_lm``, ``gpt2_lm_program`` (causal-LM training: forward,
fuse passes, backward, Adam), ``make_fake_lm_batch``,
``gpt2_logits_program`` (its startup initializes the weights),
``gpt2_decode_step_program`` (the KV-cached decode step, one token or a
chunk at a scalar position) with the generation loops over it (chunked
prefill, greedy, sampled and beam) and the speculative loops
(``speculative_generate_cached``, ``speculative_sample_generate_cached``:
a draft proposes, one wide target dispatch verifies),
``greedy_generate`` and ``beam_generate`` on the logits program, and
``gpt2_ragged_step_program`` (the serving engine's step).  Built under
``unique_name.guard()`` as in the reference, so the parameter names are
the reference's and weights cross between the packages by name
(``paddle_tpu_torch.io.params_from_numpy``).

The modern-decoder options of ``GPT2Config`` are ported: ``n_kv_head``
(grouped-query attention), ``use_rotary`` (RoPE on q and k instead of
the position table), ``use_swiglu`` (the gated SiLU FFN, ``ffn_gate.w``
and ``ffn_up.w`` in place of ``ffn_in.w``, its hidden width 2/3 of 4 d
rounded up to ``ffn_multiple_of``; the matmul_swiglu kernel).  Options
not ported yet raise: ``recompute`` (ROADMAP A9).
``gpt2_lm_program``'s ``use_bf16`` applies ``bf16_amp_pass``; on the
card its bf16 ``fused_attention`` runs B3's bf16 forms (forward, dq,
dk/dv) and the modern decoder's bf16 ``fused_swiglu`` B6's, beside the
bf16 forms of B5 and B4 (the residual stream's B2 and ``ln_f``'s B1
stay float32, as the reference's AMP pass leaves them).  Its ``mesh``
stamps the program with the family's training rules: the executor runs
the vocab projection's slab and raises for the trunk's entries (A7).
"""

import numpy as np

from .. import framework, layers, unique_name
from ..initializer import Normal
from ..param_attr import ParamAttr

__all__ = ["GPT2Config", "gpt2_lm", "gpt2_lm_program", "make_fake_lm_batch",
           "gpt2_logits_program", "gpt2_decode_step_program",
           "gpt2_ragged_step_program", "prefill_cached_chunked",
           "greedy_generate_cached", "sample_generate_cached",
           "beam_generate_cached", "speculative_generate_cached",
           "speculative_sample_generate_cached", "greedy_generate",
           "beam_generate"]


class GPT2Config:
    """GPT-2 small: vocab 50257, n_ctx 1024, d_model 768, 12 layers, 12
    heads, learned positions, gelu MLP, untied head."""

    vocab_size = 50257
    n_ctx = 1024
    d_model = 768
    n_layer = 12
    n_head = 12
    n_kv_head = None
    use_rotary = False
    use_swiglu = False
    ffn_multiple_of = 1
    tie_embeddings = False
    dropout = 0.1
    recompute = False
    partition_family = "gpt2"


def _pa(base, std=0.02):
    return ParamAttr(name=unique_name.generate(base),
                     initializer=Normal(0.0, std))


def _attn(x, hp, is_test, cache=None):
    from . import transformer as tfm

    return tfm.multi_head_attention(
        x, x, x, None, hp.d_model, hp.n_head, dropout_rate=0.0,
        is_test=is_test, fused=True, causal=cache is None, cache=cache,
        n_kv_head=getattr(hp, "n_kv_head", None),
        rotary=getattr(hp, "use_rotary", False))


def _block(x, hp, is_test, cache=None):
    """One decoder block: x + dropout(attn(ln(x))), then
    x + dropout(ffn(ln(x))); dropout only when training."""
    a = _attn(layers.layer_norm(x, begin_norm_axis=2), hp, is_test, cache)
    if hp.dropout and not is_test:
        a = layers.dropout(a, hp.dropout, is_test=is_test)
    x = layers.elementwise_add(x, a)
    ln = layers.layer_norm(x, begin_norm_axis=2)
    if getattr(hp, "use_swiglu", False):
        # silu(ln W_g) * (ln W_u), the hidden width 2/3 of 4 d (the gelu
        # MLP's parameter count) rounded up to ffn_multiple_of
        mult = int(getattr(hp, "ffn_multiple_of", 1) or 1)
        hid = -(-int(4 * hp.d_model * 2 // 3) // mult) * mult
        gate = layers.fc(ln, size=hid, num_flatten_dims=2, act="swish",
                         bias_attr=False, param_attr=_pa("ffn_gate.w"))
        up = layers.fc(ln, size=hid, num_flatten_dims=2, bias_attr=False,
                       param_attr=_pa("ffn_up.w"))
        h = layers.elementwise_mul(gate, up)
    else:
        h = layers.fc(ln, size=4 * hp.d_model, num_flatten_dims=2,
                      act="gelu", param_attr=_pa("ffn_in.w"),
                      bias_attr=_pa("ffn_in.b"))
    h = layers.fc(h, size=hp.d_model, num_flatten_dims=2,
                  param_attr=_pa("ffn_out.w"))
    if hp.dropout and not is_test:
        h = layers.dropout(h, hp.dropout, is_test=is_test)
    return layers.elementwise_add(x, h)


def _tied_logits(x, hp, emb_name):
    """x @ emb.w^T when tie_embeddings, else a separate softmax_out.w."""
    if getattr(hp, "tie_embeddings", False):
        w = framework.default_main_program().global_block().var(emb_name)
        return layers.matmul(x, w, transpose_y=True)
    return layers.fc(x, size=hp.vocab_size, num_flatten_dims=2,
                     bias_attr=False, param_attr=_pa("softmax_out.w"))


def gpt2_lm(ids, hp=GPT2Config, is_test=False):
    """[B, T] token ids -> [B, T, vocab] next-token logits."""
    emb_attr = _pa("emb.w")
    tok = layers.embedding(ids, size=[hp.vocab_size, hp.d_model],
                           param_attr=emb_attr)
    if getattr(hp, "use_rotary", False):
        x = tok  # positions enter through RoPE on q and k
    else:
        pos_table = layers.create_parameter(
            shape=[hp.n_ctx, hp.d_model], dtype="float32",
            attr=_pa("pos_emb.w", 0.01))
        pos = layers.slice(pos_table, axes=[0], starts=[0],
                           ends=[ids.shape[1]])
        x = layers.elementwise_add(tok, pos, axis=1)
    if hp.dropout and not is_test:
        x = layers.dropout(x, hp.dropout, is_test=is_test)
    for _ in range(hp.n_layer):
        x = _block(x, hp, is_test)
    x = layers.layer_norm(x, begin_norm_axis=2)
    return _tied_logits(x, hp, emb_attr.name)


def gpt2_lm_program(hp=GPT2Config, seq_len=128, lr=3e-4, is_test=False,
                    use_bf16=False, mesh=None):
    """(main, startup, feeds, [loss, token_count]) for causal-LM
    training: ids/labels [B, T] int64 and loss_weight [B, T] float feeds;
    the loss is the weighted mean token cross entropy (an all-pad batch
    gives 0, never 0/0).  linear_xent_fuse_pass (the [B, T, V] logits
    never exist) and matmul_epilogue_fuse_pass run before Adam.minimize,
    as in the reference, then use_bf16's ``bf16_amp_pass``.  The
    reference's rematerialization hook emits nothing without its
    HBM-budget flag (FLAGS_hbm_budget_bytes, 0 by default), and its pass
    is not ported yet (ROADMAP A9), so nothing is emitted here either."""
    if getattr(hp, "recompute", False) and not is_test:
        raise NotImplementedError("per-layer rematerialization "
                                  "(layers.recompute) is not ported yet "
                                  "(ROADMAP A9)")
    from .. import optimizer
    from ..transpiler.pass_registry import apply_pass

    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup), unique_name.guard():
        ids = layers.data("ids", shape=[seq_len], dtype="int64")
        lbl = layers.data("labels", shape=[seq_len], dtype="int64")
        w = layers.data("loss_weight", shape=[seq_len], dtype="float32")
        logits = gpt2_lm(ids, hp, is_test)
        cost = layers.softmax_with_cross_entropy(logits,
                                                 layers.unsqueeze(lbl, [2]))
        cost = layers.elementwise_mul(cost, layers.unsqueeze(w, [2]))
        tokens = layers.reduce_sum(w)
        loss = layers.elementwise_div(layers.reduce_sum(cost),
                                      layers.clip(tokens, 1e-5, 1e30))
        apply_pass(main, "linear_xent_fuse_pass")
        apply_pass(main, "matmul_epilogue_fuse_pass")
        if use_bf16:
            apply_pass(main, "bf16_amp_pass")
        if not is_test:
            optimizer.Adam(learning_rate=lr).minimize(loss)
    if mesh is not None:
        # the training stamp: the family's rules lifted to training names
        # (grads and Adam moments follow their param); the executor runs
        # the vocab projection's slab and raises for what is not ported
        from ..parallel.partition_rules import (annotate_spmd,
                                                train_partition_rules_for)

        annotate_spmd(main, mesh, train_partition_rules_for(
            getattr(hp, "partition_family", "gpt2")))
    return main, startup, ["ids", "labels", "loss_weight"], [loss, tokens]


def make_fake_lm_batch(batch_size, seq_len, hp=GPT2Config, seed=0):
    """A seeded synthetic batch: next-token labels, every weight 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, hp.vocab_size, (batch_size, seq_len + 1)).astype("int64")
    return {
        "ids": ids[:, :-1],
        "labels": ids[:, 1:],
        "loss_weight": np.ones((batch_size, seq_len), "float32"),
    }


def gpt2_logits_program(hp=GPT2Config, seq_len=128):
    """Inference program fetching the full [B, T, vocab] logits; its
    startup program initializes every weight."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup), unique_name.guard():
        ids = layers.data("ids", shape=[seq_len], dtype="int64")
        logits = gpt2_lm(ids, hp, is_test=True)
    return main, startup, ["ids"], [logits]


def gpt2_decode_step_program(hp=GPT2Config, batch=1, t_max=None, width=1,
                             cache_dtype="float32"):
    """The KV-cached decode step:

        feeds:  step_ids [B, W] int64, pos [1] int64
                (+ pos_vec [W] int64 when W > 1: positions pos..pos+W-1)
        fetch:  next-token logits, [B, vocab] (W 1) or [B, W, vocab]
                (W > 1; row i predicts position pos + i + 1)
        state:  per-layer gpt2_{k,v}cache_<i> persistables
                [B, n_kv_head or n_head, t_max, dh] in `cache_dtype`

    cache_dtype "bfloat16" halves the caches' bytes: seq_cache_write
    rounds the new keys and values to bf16, and the attention kernels
    read them widened to float32 beside a float32 query (their bf16-KV
    forms).  W 1 is the one-token step; W > 1 the chunked step (prefill): one
    run writes W cache slots and scores W positions with offset-causal
    attention (the flash_attention_piece kernel).  Returns (main,
    cache_startup, feeds, fetches, cache_names); run `cache_startup` to
    zero the caches before each generation.  Built under
    unique_name.guard(), so the weights are shared by name with
    gpt2_lm_program and gpt2_logits_program."""
    from .decode_cache import add_cache_zero_fills, create_kv_caches

    t_max = t_max or hp.n_ctx
    if t_max > hp.n_ctx:
        raise ValueError("t_max %d exceeds the position table n_ctx %d"
                         % (t_max, hp.n_ctx))
    width = int(width)
    if not 1 <= width <= t_max:
        raise ValueError("width %d outside [1, t_max %d]" % (width, t_max))
    dh = hp.d_model // hp.n_head
    main = framework.Program()
    cache_startup = framework.Program()  # only the cache zeroing
    throwaway_startup = framework.Program()  # weights come by name
    with framework.program_guard(main, throwaway_startup), unique_name.guard():
        ids = layers.data("step_ids", shape=[batch, width], dtype="int64",
                          append_batch_size=False)
        pos = layers.data("pos", shape=[1], dtype="int64",
                          append_batch_size=False)
        pos_vec = None
        if width > 1:
            pos_vec = layers.data("pos_vec", shape=[width], dtype="int64",
                                  append_batch_size=False)
        emb_attr = _pa("emb.w")
        tok = layers.embedding(ids, size=[hp.vocab_size, hp.d_model],
                               param_attr=emb_attr)
        tok = layers.reshape(tok, shape=[batch, width, hp.d_model])
        if getattr(hp, "use_rotary", False):
            x = tok  # RoPE rotates q and k by position in the attention
        else:
            pos_table = layers.create_parameter(
                shape=[hp.n_ctx, hp.d_model], dtype="float32",
                attr=_pa("pos_emb.w", 0.01))
            if width == 1:
                pos_row = layers.reshape(layers.gather(pos_table, pos),
                                         shape=[1, 1, hp.d_model])
                x = layers.elementwise_add(tok, pos_row)
            else:
                x = layers.elementwise_add(
                    tok, layers.gather(pos_table, pos_vec), axis=1)
        n_kv = getattr(hp, "n_kv_head", None) or hp.n_head
        kv_caches, cache_names = create_kv_caches(
            main.global_block(), "gpt2", hp.n_layer, batch, n_kv, t_max, dh,
            dtype=cache_dtype)
        add_cache_zero_fills(
            cache_startup,
            [(n, (batch, n_kv, t_max, dh)) for n in cache_names],
            dtype=cache_dtype)
        for cache in kv_caches:
            cache["pos"] = pos
            if pos_vec is not None:
                cache["pos_vec"] = pos_vec
            x = _block(x, hp, is_test=True, cache=cache)
        x = layers.layer_norm(x, begin_norm_axis=2)
        logits = _tied_logits(x, hp, emb_attr.name)
        if width == 1:
            logits = layers.reshape(logits, shape=[batch, hp.vocab_size])
        feeds = ["step_ids", "pos"] + (["pos_vec"] if pos_vec is not None
                                       else [])
        _apply_decode_epilogue_passes(main, logits)
    return main, cache_startup, feeds, [logits], cache_names


def gpt2_ragged_step_program(hp=GPT2Config, batch=4, t_max=None, width=8,
                             cache_dtype="float32", cache_prefix="gpt2"):
    """The continuous-batching serving step: width-W decode over a pool
    of `batch` cache slots, each at its own position.

        feeds:  step_ids [B, W] int64, pos_rows [B] int64,
                width_rows [B] int64, pos_mat [B, W] int64
        fetch:  logits [B, W, vocab] — row b column i predicts position
                pos_rows[b] + i + 1
        state:  per-layer <cache_prefix>_{k,v}cache_<i> persistables
                [batch, n_kv_head or n_head, t_max, dh] in
                `cache_dtype` (float32 or bfloat16, as the decode step's)

    Cache writes go through slot_cache_write (per-row position and
    width, out-of-width columns dropped) and attention masks per-row
    offset-causal (fused_attention with a vector qstart).  Row b's
    logits depend only on row b's request, the serving engine's
    pooled == solo contract.  Returns (main, cache_startup, feeds,
    fetches, cache_names)."""
    from .decode_cache import add_cache_zero_fills, create_kv_caches

    t_max = t_max or hp.n_ctx
    assert t_max <= hp.n_ctx, (
        "t_max %d exceeds the position table n_ctx %d" % (t_max, hp.n_ctx))
    width = int(width)
    assert 1 <= width <= t_max, (width, t_max)
    dh = hp.d_model // hp.n_head
    main = framework.Program()
    cache_startup = framework.Program()
    throwaway_startup = framework.Program()  # weights come by name
    with framework.program_guard(main, throwaway_startup), unique_name.guard():
        ids = layers.data("step_ids", shape=[batch, width], dtype="int64",
                          append_batch_size=False)
        pos_rows = layers.data("pos_rows", shape=[batch], dtype="int64",
                               append_batch_size=False)
        width_rows = layers.data("width_rows", shape=[batch], dtype="int64",
                                 append_batch_size=False)
        pos_mat = layers.data("pos_mat", shape=[batch, width], dtype="int64",
                              append_batch_size=False)
        emb_attr = _pa("emb.w")
        tok = layers.embedding(ids, size=[hp.vocab_size, hp.d_model],
                               param_attr=emb_attr)
        tok = layers.reshape(tok, shape=[batch, width, hp.d_model])
        rotary = getattr(hp, "use_rotary", False)
        if rotary:
            x = tok  # RoPE rotates q and k by pos_mat in the attention
        else:
            pos_table = layers.create_parameter(
                shape=[hp.n_ctx, hp.d_model], dtype="float32",
                attr=_pa("pos_emb.w", 0.01))
            x = layers.elementwise_add(tok, layers.gather(pos_table, pos_mat))
        n_kv = getattr(hp, "n_kv_head", None) or hp.n_head
        kv_caches, cache_names = create_kv_caches(
            main.global_block(), cache_prefix, hp.n_layer, batch, n_kv,
            t_max, dh, dtype=cache_dtype)
        add_cache_zero_fills(
            cache_startup,
            [(n, (batch, n_kv, t_max, dh)) for n in cache_names],
            dtype=cache_dtype)
        for cache in kv_caches:
            cache["pos_rows"] = pos_rows
            cache["width_rows"] = width_rows
            if rotary:
                cache["pos_mat"] = pos_mat
            x = _block(x, hp, is_test=True, cache=cache)
        x = layers.layer_norm(x, begin_norm_axis=2)
        logits = _tied_logits(x, hp, emb_attr.name)
        _apply_decode_epilogue_passes(main, logits)
    feeds = ["step_ids", "pos_rows", "width_rows", "pos_mat"]
    return main, cache_startup, feeds, [logits], cache_names


def _apply_decode_epilogue_passes(main, logits):
    """Apply the matmul-epilogue fuse bundle, protecting the logits fetch
    (a fuse deletes every intermediate of its chain)."""
    from ..transpiler import apply_pass

    prev = tuple(getattr(main, "_protected_fetch_names", ()) or ())
    main._protected_fetch_names = tuple(dict.fromkeys(prev + (logits.name,)))
    apply_pass(main, "matmul_epilogue_fuse_pass")


def _prefill_cached(exe, step_main, fetches, ids):
    """Feed the prompt one token at a time (filling the caches); returns
    the logits after the last prompt token (they predict position p)."""
    logits = None
    for t in range(ids.shape[1]):
        (logits,) = exe.run(
            step_main,
            feed={"step_ids": ids[:, t:t + 1], "pos": np.array([t], "int64")},
            fetch_list=fetches)
    return logits


def _speculative_core(
        exe, tgt_step_main, tgt_cache_startup, tgt_step_fetch,
        tgt_wide_main, tgt_wide_fetch, spec_k,
        draft_step_main, draft_cache_startup, draft_step_fetch,
        prompt_ids, max_new_tokens, draft_scope,
        target_pick, draft_pick, resolve_round):
    """The speculative round, shared by the greedy and the sampling
    loops, which plug in their token rules:

    - target_pick(logits [B, V]) -> [B] token (prefill, capacity tail)
    - draft_pick(logits [B, V]) -> ([B] token, aux); aux goes to the
      resolver (the sampling loop's filtered draft probabilities)
    - resolve_round(wl [B, spec_k, V], drafts, aux) -> (accepted token
      list, cur [B], j): wl row i is the target's distribution at
      position pos+i+1 given chunk[:, :i+1]; j tokens were accepted and
      `cur` goes to position pos+j+1

    A round: the draft proposes k = spec_k-1 tokens one step at a time,
    one width-spec_k target dispatch scores the anchor and the drafts,
    the resolver keeps the longest valid prefix.  Rejected tokens' K/V
    lie beyond the accepted position, masked until overwritten.  Near the
    cache's end the tail takes one-token target steps (a fixed-width
    verify write would clamp onto valid slots)."""
    from ..core.scope import global_scope
    from .decode_cache import (probe_cache_dtype, probe_cache_len,
                               validate_cached_call)

    prompt_ids = np.asarray(prompt_ids, "int64")
    b, p = prompt_ids.shape
    spec_k = int(spec_k)
    if spec_k < 2:
        raise ValueError(
            "speculative decoding needs spec_k >= 2 (the wide verify "
            "program needs width > 1; spec_k == 1 is just the plain "
            "cached generator)")
    validate_cached_call(tgt_step_main, "gpt2", "step_ids", b, p,
                         max_new_tokens)
    t_max = probe_cache_len(tgt_wide_main, "gpt2")
    step_t_max = probe_cache_len(tgt_step_main, "gpt2")
    if t_max != step_t_max:
        raise ValueError(
            "speculative decode: wide program cache length %d != step "
            "program's %d — both must address the same cache"
            % (t_max, step_t_max))
    wd = probe_cache_dtype(tgt_wide_main, "gpt2")
    sd = probe_cache_dtype(tgt_step_main, "gpt2")
    if wd != sd:
        raise ValueError(
            "speculative decode: wide program cache dtype %s != step "
            "program's %s — build both with the same cache_dtype"
            % (wd, sd))
    draft_scope = draft_scope if draft_scope is not None else global_scope()

    def run_draft(main, feed, fetches):
        return exe.run(main, feed=feed, fetch_list=fetches,
                       scope=draft_scope)

    # prefill both caches with the prompt; the target's through its wide
    # program
    exe.run(tgt_cache_startup)
    run_draft(draft_cache_startup, {}, [])
    tgt_logits = prefill_cached_chunked(
        exe, tgt_wide_main, tgt_wide_fetch, prompt_ids, spec_k, t_max)
    for t in range(p):
        run_draft(draft_step_main,
                  feed={"step_ids": prompt_ids[:, t:t + 1],
                        "pos": np.array([t], "int64")},
                  fetches=draft_step_fetch)

    out = [prompt_ids[:, i] for i in range(p)]
    # the batch's rows advance in lockstep on the slowest row's
    # acceptance; every row's tokens stay valid under its own rule
    cur = target_pick(tgt_logits)  # token at position p
    pos = p
    proposals = accepted_total = rounds = 0
    while pos < p + max_new_tokens:
        out.append(cur)
        if pos + 1 >= p + max_new_tokens:
            break
        if pos + spec_k > t_max:
            # capacity tail: one-token target steps
            (tl,) = exe.run(
                tgt_step_main,
                feed={"step_ids": cur[:, None],
                      "pos": np.array([pos], "int64")},
                fetch_list=tgt_step_fetch)
            cur = target_pick(tl)
            pos += 1
            continue
        k = min(spec_k - 1, p + max_new_tokens - pos - 2)
        drafts, aux = [], []
        (dl,) = run_draft(
            draft_step_main,
            feed={"step_ids": cur[:, None], "pos": np.array([pos], "int64")},
            fetches=draft_step_fetch)
        for i in range(k):
            tok, a = draft_pick(dl)
            drafts.append(tok)
            aux.append(a)
            (dl,) = run_draft(
                draft_step_main,
                feed={"step_ids": tok[:, None],
                      "pos": np.array([pos + 1 + i], "int64")},
                fetches=draft_step_fetch)
        # one target dispatch scores cur and the k drafts: row i is the
        # target's distribution at position pos+i+1
        chunk = np.stack([cur] + drafts, axis=1)
        if chunk.shape[1] < spec_k:
            chunk = np.pad(chunk, ((0, 0), (0, spec_k - chunk.shape[1])))
        (wl,) = exe.run(
            tgt_wide_main,
            feed={"step_ids": chunk,
                  "pos": np.array([pos], "int64"),
                  "pos_vec": np.minimum(
                      np.arange(pos, pos + spec_k, dtype="int64"),
                      t_max - 1)},
            fetch_list=tgt_wide_fetch)
        rounds += 1
        proposals += k
        acc, cur, j = resolve_round(np.asarray(wl), drafts, aux)
        out.extend(acc)
        accepted_total += j
        pos = pos + 1 + j
    tokens = np.stack(out, axis=1)[:, :p + max_new_tokens]
    stats = {
        "rounds": rounds,
        "proposed": proposals,
        "accepted": accepted_total,
        "accept_rate": (accepted_total / proposals) if proposals else 1.0,
    }
    return tokens, stats


def speculative_generate_cached(
        exe, tgt_step_main, tgt_cache_startup, tgt_step_fetch,
        tgt_wide_main, tgt_wide_fetch, spec_k,
        draft_step_main, draft_cache_startup, draft_step_fetch,
        prompt_ids, max_new_tokens, draft_scope=None):
    """Speculative greedy decoding: the resolver keeps the longest prefix
    where every batch row's draft equals the target's argmax, then takes
    the target's bonus or correction token.  The tokens are the target's
    own greedy_generate_cached sequence for any draft; the draft changes
    only how many target dispatches it takes.  draft_scope: the draft
    model's own Scope (its weights and caches); the current scope by
    default (a self-draft).  Returns (tokens [B, P+new], stats dict)."""
    from .decode_cache import greedy_accept_len

    def target_pick(logits):
        return np.asarray(logits).argmax(-1).astype("int64")

    def draft_pick(logits):
        return np.asarray(logits).argmax(-1).astype("int64"), None

    def resolve(wl, drafts, aux):
        tgt_next = wl.argmax(-1).astype("int64")  # [B, spec_k]
        j = greedy_accept_len(tgt_next, drafts)
        # bonus (all accepted) or correction (first mismatch)
        return list(drafts[:j]), tgt_next[:, j], j

    return _speculative_core(
        exe, tgt_step_main, tgt_cache_startup, tgt_step_fetch,
        tgt_wide_main, tgt_wide_fetch, spec_k,
        draft_step_main, draft_cache_startup, draft_step_fetch,
        prompt_ids, max_new_tokens, draft_scope,
        target_pick, draft_pick, resolve)


def speculative_sample_generate_cached(
        exe, tgt_step_main, tgt_cache_startup, tgt_step_fetch,
        tgt_wide_main, tgt_wide_fetch, spec_k,
        draft_step_main, draft_cache_startup, draft_step_fetch,
        prompt_ids, max_new_tokens, temperature=1.0, top_k=0, top_p=1.0,
        seed=None, draft_scope=None):
    """Speculative sampling (rejection sampling): the draft proposes
    d ~ p_d, accepted with probability min(1, p_t(d)/p_d(d)); a rejected
    token is drawn again from normalize(max(p_t - p_d, 0)).  The tokens
    follow the target's filtered sampling distribution (the same
    temperature / top_k / top_p on both models' logits) for any draft.
    A round stops at the first index where any batch row rejects; there
    accepted rows keep their draft token and rejected rows draw the
    residual.  Returns (tokens [B, P+new], stats dict)."""
    from .decode_cache import filtered_probs, residual_probs, sample_rows

    rng = np.random.RandomState(seed)
    b = np.asarray(prompt_ids).shape[0]

    def probs(logits):
        return filtered_probs(logits, temperature, top_k, top_p)

    def target_pick(logits):
        return sample_rows(probs(logits), rng)

    def draft_pick(logits):
        pd = probs(logits)
        return sample_rows(pd, rng), pd

    def resolve(wl, drafts, aux):
        j, acc = 0, []
        while j < len(drafts):
            pt = probs(wl[:, j])
            pd = aux[j]
            d = drafts[j]
            ratio = (np.take_along_axis(pt, d[:, None], 1).reshape(-1)
                     / np.maximum(
                         np.take_along_axis(pd, d[:, None], 1).reshape(-1),
                         1e-12))
            reject = rng.rand(b) > ratio
            if not reject.any():
                acc.append(d)
                j += 1
                continue
            # stop: rejected rows draw the residual, accepted rows keep d
            repl = sample_rows(residual_probs(pt, pd), rng)
            return acc, np.where(reject, repl, d).astype("int64"), j
        # every draft accepted: the bonus from the target's last row
        return acc, sample_rows(probs(wl[:, len(drafts)]), rng), j

    return _speculative_core(
        exe, tgt_step_main, tgt_cache_startup, tgt_step_fetch,
        tgt_wide_main, tgt_wide_fetch, spec_k,
        draft_step_main, draft_cache_startup, draft_step_fetch,
        prompt_ids, max_new_tokens, draft_scope,
        target_pick, draft_pick, resolve)


def _dispatch_prefill(exe, step_main, fetches, ids, prefill):
    """Prefill the caches with `ids`: chunked through the wide program
    when `prefill` = (wide_main, wide_fetches, width[, t_max]) is given,
    one-token steps otherwise.  The wide program's cache length, cache
    dtype, width and static batch are checked against the step
    program's: a wrong t_max would let the chunked writes clamp onto
    valid slots, and a beam path needs the wide program built with
    batch = B * beam_size."""
    if prefill is None:
        return _prefill_cached(exe, step_main, fetches, ids)
    from .decode_cache import probe_cache_dtype, probe_cache_len

    wm, wf, width = prefill[0], prefill[1], int(prefill[2])
    t_max = probe_cache_len(wm, "gpt2")
    step_t_max = probe_cache_len(step_main, "gpt2")
    if t_max != step_t_max:
        raise ValueError(
            "prefill wide program cache length %d != the step program's %d "
            "— both must address the same cache capacity or the chunked "
            "writes land on wrong slots" % (t_max, step_t_max))
    wd, sd = probe_cache_dtype(wm, "gpt2"), probe_cache_dtype(step_main,
                                                             "gpt2")
    if wd != sd:
        raise ValueError("prefill wide program cache dtype %s != the step "
                         "program's %s" % (wd, sd))
    if len(prefill) > 3 and int(prefill[3]) != t_max:
        raise ValueError("prefill t_max %d does not match the wide program's "
                         "cache length %d" % (int(prefill[3]), t_max))
    ids_var = wm.global_block().var("step_ids")
    wb, ww = int(ids_var.shape[0]), int(ids_var.shape[1])
    if ww != width:
        raise ValueError("prefill width %d != the wide program's step_ids "
                         "width %d" % (width, ww))
    if wb != ids.shape[0]:
        raise ValueError(
            "prefill wide program batch %d != %d rows to prefill (beam paths "
            "need the wide program built with batch = B * beam_size)"
            % (wb, ids.shape[0]))
    return prefill_cached_chunked(exe, wm, wf, ids, width, t_max)


def prefill_cached_chunked(exe, wide_main, wide_fetches, ids, width, t_max):
    """Fill the caches with the prompt in ceil(P/W) width-W runs of
    gpt2_decode_step_program(width=W) instead of P one-token steps;
    returns the logits predicting position P (equal to one-token
    prefill's).  The last chunk re-anchors to t_max - W when it would
    write past the cache (rewriting earlier slots with the same tokens
    is idempotent); pad rows beyond the prompt land in slots the
    generation loop overwrites before it attends them."""
    from .decode_cache import run_chunked_ids

    ids = np.asarray(ids, "int64")
    p = ids.shape[1]
    logits = last_c0 = None
    for c0, lg in run_chunked_ids(exe, wide_main, wide_fetches, ids, width,
                                  t_max, "step_ids", has_pos_vec=True):
        logits, last_c0 = lg, c0
    return logits[:, (p - 1) - last_c0]


def greedy_generate_cached(exe, step_main, cache_startup, fetches,
                           prompt_ids, max_new_tokens, prefill=None):
    """Greedy decoding through the KV-cached step program: the prefill
    fills the caches from the prompt, then each new token costs one
    step.  Equals greedy_generate token for token.  prefill: optional
    (wide_main, wide_fetches, width, t_max) from
    gpt2_decode_step_program(width=W), chunked prefill in ceil(P/W)
    runs instead of P.  Returns [B, P + max_new_tokens] int64."""
    from .decode_cache import validate_cached_call

    prompt_ids = np.asarray(prompt_ids, "int64")
    b, p = prompt_ids.shape
    validate_cached_call(step_main, "gpt2", "step_ids", b, p, max_new_tokens)
    exe.run(cache_startup)  # zero the caches for this generation
    out = [prompt_ids[:, i] for i in range(p)]
    logits = _dispatch_prefill(exe, step_main, fetches, prompt_ids, prefill)
    for t in range(p, p + max_new_tokens):
        nxt = np.asarray(logits).argmax(axis=-1).astype("int64")
        out.append(nxt)
        if t + 1 >= p + max_new_tokens:
            break
        (logits,) = exe.run(
            step_main,
            feed={"step_ids": nxt[:, None], "pos": np.array([t], "int64")},
            fetch_list=fetches)
    return np.stack(out, axis=1)


def sample_generate_cached(exe, step_main, cache_startup, fetches,
                           prompt_ids, max_new_tokens, temperature=1.0,
                           top_k=0, top_p=1.0, seed=None, eos_id=None,
                           pad_id=0, prefill=None):
    """Stochastic decoding through the KV-cached step: temperature
    scaling, top-k and/or nucleus (top-p) filtering, seeded numpy
    sampling (top_k=1 is greedy).  prefill: as greedy_generate_cached's.
    Returns [B, P + max_new_tokens] int64."""
    from .decode_cache import sample_from_logits, validate_cached_call

    prompt_ids = np.asarray(prompt_ids, "int64")
    b, p = prompt_ids.shape
    validate_cached_call(step_main, "gpt2", "step_ids", b, p, max_new_tokens)
    rng = np.random.RandomState(seed)
    exe.run(cache_startup)
    logits = _dispatch_prefill(exe, step_main, fetches, prompt_ids, prefill)
    out = [prompt_ids[:, i] for i in range(p)]
    done = np.zeros(b, bool)
    for t in range(p, p + max_new_tokens):
        nxt = sample_from_logits(logits, rng, temperature, top_k, top_p)
        if eos_id is not None:
            nxt = np.where(done, pad_id, nxt)
            done |= nxt == eos_id
        out.append(nxt)
        if t + 1 >= p + max_new_tokens or (eos_id is not None and done.all()):
            break
        (logits,) = exe.run(step_main, feed={
            "step_ids": nxt[:, None], "pos": np.array([t], "int64")},
            fetch_list=fetches)
    # an early all-eos exit pads to the documented width
    while len(out) < p + max_new_tokens:
        out.append(np.full(b, pad_id, "int64"))
    return np.stack(out, axis=1)


def beam_generate_cached(exe, step_main, cache_startup, fetches, prompt_ids,
                         max_new_tokens, beam_size=4, eos_id=None, pad_id=0,
                         length_penalty=0.0, prefill=None):
    """Beam-search decoding through the KV-cached step program, built
    with batch = B * beam_size: the surviving beams' caches shuffle
    through a gather/assign reorder program each step.  prefill: as
    greedy_generate_cached's, its wide program also built with batch =
    B * beam_size.  Returns (ids [B, T_out], scores [B])."""
    from ..contrib.decoder.beam_search_decoder import incremental_beam_search
    from .decode_cache import make_cache_reorder_program, validate_cached_call

    prompt_ids = np.asarray(prompt_ids, "int64")
    b, p = prompt_ids.shape
    validate_cached_call(step_main, "gpt2", "step_ids", b, p, max_new_tokens,
                         beams=beam_size)
    cache_shapes = [
        (n, v.shape, v.dtype)
        for n, v in step_main.global_block().vars.items()
        if n.startswith(("gpt2_kcache_", "gpt2_vcache_"))]
    reorder = make_cache_reorder_program(cache_shapes, b * beam_size)

    exe.run(cache_startup)
    rep = np.repeat(prompt_ids, beam_size, axis=0)
    logits = _dispatch_prefill(exe, step_main, fetches, rep, prefill)

    def step_fn(tokens, pos):
        (lg,) = exe.run(step_main,
                        feed={"step_ids": tokens,
                              "pos": np.array([pos], "int64")},
                        fetch_list=fetches)
        return lg

    def reorder_fn(rows):
        exe.run(reorder, feed={"parents": rows.astype("int64")},
                fetch_list=[])

    return incremental_beam_search(
        step_fn, reorder_fn, logits, prompt_ids, p, beam_size,
        p + max_new_tokens, eos_id if eos_id is not None else -1, pad_id,
        length_penalty)


def _prompt_buffer(main, prompt_ids, max_new_tokens, pad_id):
    """The uncached loops' prologue: check the prompt against the
    program's length and left-align it in a pad-filled [B, T] buffer."""
    T = int(main.global_block().vars["ids"].shape[1])
    prompt_ids = np.asarray(prompt_ids, "int64")
    b, p = prompt_ids.shape
    if p < 1:
        raise ValueError("empty prompt: seed generation with at least a BOS "
                         "token")
    if p + max_new_tokens > T:
        raise ValueError("program seq_len %d < prompt %d + new %d"
                         % (T, p, max_new_tokens))
    buf = np.full((b, T), pad_id, "int64")
    buf[:, :p] = prompt_ids
    return buf, p


def greedy_generate(exe, main, fetches, prompt_ids, max_new_tokens,
                    pad_id=0):
    """Greedy decoding on the fixed-shape logits program
    (gpt2_logits_program): the prompt is right-padded to the program's T,
    each step feeds the updated ids and reads the logits at the last
    real position; causal masking keeps the padded tail invisible.
    prompt_ids [B, P] int64; returns [B, P + max_new_tokens] int64."""
    buf, p = _prompt_buffer(main, prompt_ids, max_new_tokens, pad_id)
    cur = p
    for _ in range(max_new_tokens):
        (logits,) = exe.run(main, feed={"ids": buf}, fetch_list=fetches)
        buf[:, cur] = np.asarray(logits)[:, cur - 1, :].argmax(axis=-1)
        cur += 1
    return buf[:, :cur]


def beam_generate(exe, main, fetches, prompt_ids, max_new_tokens,
                  beam_size=4, eos_id=None, pad_id=0, length_penalty=0.0):
    """Beam-search decoding on the same fixed-shape logits program as
    greedy_generate.  Returns (ids [B, T_out], scores [B])."""
    from ..contrib.decoder.beam_search_decoder import full_sequence_beam_search

    buf, p = _prompt_buffer(main, prompt_ids, max_new_tokens, pad_id)

    def logits_fn(rows, cur):
        (logits,) = exe.run(main, feed={"ids": rows}, fetch_list=fetches)
        return np.asarray(logits)[:, cur - 1, :]

    return full_sequence_beam_search(
        logits_fn, buf, p, beam_size, p + max_new_tokens,
        eos_id if eos_id is not None else -1, pad_id, length_penalty)
