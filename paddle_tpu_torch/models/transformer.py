"""Transformer (the counterpart of ``paddle_tpu/models/transformer.py``):
the encoder-decoder Transformer-base of the WMT training program
(``wmt_transformer_program``, label smoothing, noam lr, Adam) and
``multi_head_attention``'s ported forms: the unfused training form
(batched matmul / softmax / dropout), the fused (flash) form, and the
cached forms of the decode step (one token or a chunk at a scalar
position) and of the serving step (ragged), each with grouped-query
attention and rotary positions as options.  Translation: the logits
program with the full re-decode greedy and beam loops, and the KV-cached
decode programs (encoder once, then one cached decoder step a token, or
W known tokens a dispatch) with their greedy, beam and sampled loops and
chunked teacher-forced rescoring.  Parameter names (mha_q.w ...
softmax_out.w) are the reference's, so the programs built here list the
same ops over the same names as the reference's."""

import numpy as np

from .. import framework, layers, unique_name
from ..initializer import Normal, NumpyArrayInitializer
from ..param_attr import ParamAttr

__all__ = ["ModelHyperParams", "multi_head_attention", "transformer",
           "wmt_transformer_program", "make_fake_batch", "pad_bias",
           "causal_plus_pad_bias", "transformer_logits_program",
           "greedy_translate", "greedy_translate_cached",
           "beam_translate_cached", "sample_translate_cached",
           "transformer_decode_programs", "force_decode_logits_cached",
           "beam_translate"]


def _pa(base):
    return ParamAttr(name=unique_name.generate(base))


class ModelHyperParams:
    """Transformer-base (the reference's ModelHyperParams)."""

    src_vocab_size = 10000
    trg_vocab_size = 10000
    max_length = 256
    d_model = 512
    d_inner_hid = 2048
    n_head = 8
    n_layer = 6
    dropout = 0.1
    label_smooth_eps = 0.1
    recompute = False
    partition_family = "transformer"


def _pos_encoding_table(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float64")
    i = np.arange(d_model)[None, :].astype("float64")
    angle = pos / np.power(10000, 2 * (i // 2) / d_model)
    table = np.zeros((max_len, d_model), dtype="float32")
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def prepare_embedding(ids, vocab_size, d_model, max_len, dropout_rate,
                      pos_name, is_test=False):
    """Word embedding scaled by sqrt(d_model) plus the sinusoid position
    table, a frozen parameter."""
    word_emb = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr=ParamAttr(initializer=Normal(0.0, d_model ** -0.5)))
    word_emb = layers.scale(word_emb, scale=d_model ** 0.5)
    pos_table = layers.create_parameter(
        shape=[max_len, d_model], dtype="float32", name=pos_name,
        attr=ParamAttr(name=pos_name, trainable=False,
                       initializer=NumpyArrayInitializer(
                           _pos_encoding_table(max_len, d_model))))
    seq_len = ids.shape[1]
    pos_slice = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq_len])
    out = layers.elementwise_add(word_emb, pos_slice, axis=1)
    if dropout_rate:
        out = layers.dropout(out, dropout_rate, is_test=is_test)
    return out


def multi_head_attention(queries, keys, values, attn_bias, d_model, n_head,
                         dropout_rate=0.0, is_test=False, cache=None,
                         fused=False, kpad_bias=None, causal=False,
                         n_kv_head=None, rotary=False):
    """All heads in one q/k/v projection each; attn_bias is an additive
    [B, 1 or H, Tq, Tk] mask.

    Ported forms: the unfused form (fused=False, no cache: batched
    matmul, softmax, attention-prob dropout, matmul), the fused form
    without a cache (flash attention, causal or with a key-padding
    bias), and the cache forms, whose cache dict carries "k"/"v" [B,
    n_kv, T_max, Dh] persistables:

    - the decode step, with the scalar "pos" [1] (and "pos_vec" [W]
      when W > 1): the W current tokens' K/V land at pos .. pos + W - 1
      (seq_cache_write); a one-token step attends with the rank-1 <=pos
      key bias (decode_pos_mask), a W-wide chunk with the offset-causal
      scalar qstart (the flash_attention_piece kernel);
    - the RAGGED serving step, with "pos_rows" [B] and "width_rows" [B]
      (and "pos_mat" [B, W] under rotary): each row writes its K/V at
      its own position with its own valid width (slot_cache_write) and
      attends with its own offset-causal cutoff (fused_attention with a
      vector qstart).

    n_kv_head < n_head is grouped-query attention: k/v project to
    n_kv_head heads, each shared by a contiguous group of n_head /
    n_kv_head query heads.  They are tiled back to n_head before
    attention in training, on the ragged path and in the W-wide decode
    chunk; the one-token step instead folds the group onto the
    length-1 query-time axis (heads n_kv, Tq = g), so its per-step K/V
    reads are n_kv-sized, as in the reference.  rotary=True rotates q
    and k after the head split (RoPE): positions arange(T) in training,
    else the cache's pos_mat, pos_vec or pos (in that order), so cached
    keys are stored rotated."""
    dh = d_model // n_head
    n_kv = n_kv_head or n_head
    if n_head % n_kv:
        raise ValueError(
            "n_kv_head (%d) must divide n_head (%d)" % (n_kv, n_head))
    q = layers.fc(queries, size=d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_pa("mha_q.w"))
    k = layers.fc(keys, size=n_kv * dh, num_flatten_dims=2, bias_attr=False,
                  param_attr=_pa("mha_k.w"))
    v = layers.fc(values, size=n_kv * dh, num_flatten_dims=2, bias_attr=False,
                  param_attr=_pa("mha_v.w"))

    def split_heads(x, heads):
        b, t = x.shape[0], x.shape[1]
        x = layers.reshape(x, [b, t, heads, dh])
        return layers.transpose(x, [0, 2, 1, 3])  # [B, heads, T, Dh]

    def repeat_kv(x):
        """[B, n_kv, T, Dh] -> [B, n_head, T, Dh]: each kv head serves a
        contiguous group of query heads."""
        if n_kv == n_head:
            return x
        g = n_head // n_kv
        b, _, t, _ = x.shape
        x = layers.reshape(x, [b, n_kv, 1, t, dh])
        x = layers.expand(x, [1, 1, g, 1, 1])
        return layers.reshape(x, [b, n_head, t, dh])

    q = split_heads(q, n_head)
    k, v = split_heads(k, n_kv), split_heads(v, n_kv)
    if rotary:
        rpos = None
        if cache is not None:
            if "pos_rows" in cache and "pos_mat" not in cache:
                raise ValueError(
                    "ragged cached attention with rotary needs pos_mat "
                    "(per-row absolute positions [B, W]) — without it "
                    "every slot would silently rotate at arange(W)")
            for key in ("pos_mat", "pos_vec", "pos"):
                if key in cache:
                    rpos = cache[key]
                    break
            if rpos is None:
                raise KeyError(
                    "cached rotary attention needs pos/pos_vec/pos_mat")
        q = layers.rotary_embed(q, pos=rpos)
        k = layers.rotary_embed(k, pos=rpos)
    if cache is None and not fused:
        k, v = repeat_kv(k), repeat_kv(v)
        product = layers.matmul(q, k, transpose_y=True, alpha=dh ** -0.5)
        if attn_bias is not None:
            product = layers.elementwise_add(product, attn_bias)
        weights = layers.softmax(product)
        if dropout_rate:
            weights = layers.dropout(weights, dropout_rate, is_test=is_test)
        ctx = layers.matmul(weights, v)  # [B, H, Tq, Dh]
    elif cache is None:
        if attn_bias is not None and kpad_bias is None:
            raise ValueError(
                "fused attention cannot consume the dense [B,H,Tq,Tk] "
                "attn_bias — pass its rank-1 key-padding row as kpad_bias")
        ctx = layers.fused_attention(q, repeat_kv(k), repeat_kv(v),
                                     bias=kpad_bias, causal=causal,
                                     scale=dh ** -0.5)
    else:
        if attn_bias is not None or kpad_bias is not None:
            raise ValueError(
                "cached attention owns its <=pos mask; attn_bias/kpad_bias "
                "are not supported on the cache path")
        if causal:
            raise ValueError("cached attention handles causality via the "
                             "cache mask — pass causal=False with cache")
        if dropout_rate:
            raise ValueError("cached decode is inference-only: dropout_rate "
                             "must be 0")
        from ..layer_helper import LayerHelper

        helper = LayerHelper("cached_attention")
        ragged = "pos_rows" in cache
        if ragged and "width_rows" not in cache:
            raise ValueError("ragged cached attention needs width_rows "
                             "alongside pos_rows (per-row valid write widths)")

        def write_cache(cvar, new):
            """The updated full-length cache, assigned back into the
            persistable var."""
            if ragged:
                out = layers.slot_cache_write(cvar, new, cache["pos_rows"],
                                              cache["width_rows"])
            else:
                out = helper.create_variable_for_type_inference(cvar.dtype)
                helper.append_op(
                    "seq_cache_write",
                    inputs={"Cache": [cvar], "New": [new],
                            "Pos": [cache["pos"]]},
                    outputs={"Out": [out]})
            helper.append_op("assign", inputs={"X": [out]},
                             outputs={"Out": [cvar]})
            return out

        if int(cache["k"].shape[1]) != n_kv:
            raise ValueError(
                "cache has %d kv heads but n_kv_head is %d — create the "
                "caches with the model's kv head count"
                % (int(cache["k"].shape[1]), n_kv))
        k_full = write_cache(cache["k"], k)
        v_full = write_cache(cache["v"], v)
        t_max = int(cache["k"].shape[2])
        bsz = int(cache["k"].shape[0])
        width = int(q.shape[2])

        def pos_bias():
            # the one-token step masks with the rank-1 <=pos key bias
            bias = helper.create_variable_for_type_inference("float32")
            helper.append_op(
                "decode_pos_mask", inputs={"Pos": [cache["pos"]]},
                outputs={"Out": [bias]},
                attrs={"t_max": t_max, "batch": bsz})
            return bias

        if ragged or width > 1:
            # per-row (ragged) or scalar (chunk) offset-causal cutoffs;
            # GQA tiles K/V back to n_head: the group fold below needs
            # the length-1 query-time axis
            ctx = layers.fused_attention(
                q, repeat_kv(k_full), repeat_kv(v_full), causal=True,
                qstart=cache["pos_rows"] if ragged else cache["pos"],
                scale=dh ** -0.5)  # [B, H, W, Dh]
        elif n_kv == n_head:
            ctx = layers.fused_attention(q, k_full, v_full, bias=pos_bias(),
                                         causal=False, scale=dh ** -0.5)
        else:
            # the g query heads of a group attend one kv head: fold the
            # group onto the query-time axis (heads n_kv, Tq = g), the
            # key bias broadcast over the g rows
            g = n_head // n_kv
            q_g = layers.reshape(q, [bsz, n_kv, g, dh])
            ctx = layers.fused_attention(q_g, k_full, v_full,
                                         bias=pos_bias(), causal=False,
                                         scale=dh ** -0.5)  # [B, n_kv, g, Dh]
            ctx = layers.reshape(ctx, [bsz, n_head, 1, dh])
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    b, t = ctx.shape[0], ctx.shape[1]
    ctx = layers.reshape(ctx, [b, t, d_model])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=_pa("mha_o.w"))


def positionwise_ffn(x, d_inner, d_model, dropout_rate=0.0, is_test=False):
    hidden = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu",
                       param_attr=_pa("ffn_in.w"), bias_attr=_pa("ffn_in.b"))
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_rate, is_test=is_test)
    return layers.fc(hidden, size=d_model, num_flatten_dims=2,
                     param_attr=_pa("ffn_out.w"))


def pre_post_process(prev, out, dropout_rate=0.0, is_test=False):
    """Dropout, residual add, layer_norm (the reference's 'dan')."""
    if dropout_rate:
        out = layers.dropout(out, dropout_rate, is_test=is_test)
    added = layers.elementwise_add(prev, out)
    return layers.layer_norm(added, begin_norm_axis=2)


def encoder_layer(x, attn_bias, hp, is_test=False, kpad_bias=None):
    fused = getattr(hp, "fused_attn", False)
    attn = multi_head_attention(x, x, x, attn_bias, hp.d_model, hp.n_head,
                                hp.dropout, is_test, fused=fused,
                                kpad_bias=kpad_bias)
    x = pre_post_process(x, attn, hp.dropout, is_test)
    ffn = positionwise_ffn(x, hp.d_inner_hid, hp.d_model, hp.dropout, is_test)
    return pre_post_process(x, ffn, hp.dropout, is_test)


def decoder_layer(x, enc_out, self_bias, cross_bias, hp, is_test=False,
                  self_kpad=None, cross_kpad=None, cache=None):
    """One decoder layer.  Without `cache` the training form; with
    `cache` ({"k", "v", "pos"} and "pos_vec" when W > 1) x is the W
    current target tokens: self-attention runs KV-cached (the decode
    step's cache form, dropout 0) and cross-attention takes the fused
    form over the whole enc_out with the rank-1 `cross_kpad`.  One
    function builds both graphs, so the parameter order (weight sharing
    by name) holds by construction."""
    fused = getattr(hp, "fused_attn", False)
    self_attn = multi_head_attention(
        x, x, x, self_bias if cache is None else None, hp.d_model,
        hp.n_head, 0.0 if cache is not None else hp.dropout, is_test,
        fused=fused or cache is not None,
        kpad_bias=self_kpad if cache is None else None,
        causal=fused and cache is None, cache=cache)
    x = pre_post_process(x, self_attn, hp.dropout, is_test)
    cross = multi_head_attention(
        x, enc_out, enc_out, cross_bias, hp.d_model, hp.n_head,
        0.0 if cache is not None else hp.dropout, is_test,
        fused=fused or cache is not None, kpad_bias=cross_kpad)
    x = pre_post_process(x, cross, hp.dropout, is_test)
    ffn = positionwise_ffn(x, hp.d_inner_hid, hp.d_model, hp.dropout, is_test)
    return pre_post_process(x, ffn, hp.dropout, is_test)


def transformer(src_ids, trg_ids, src_slf_attn_bias, trg_slf_attn_bias,
                trg_src_attn_bias, hp=ModelHyperParams, is_test=False,
                trg_kpad_bias=None):
    """Encoder-decoder; returns [B, Tt, trg_vocab] logits."""
    if getattr(hp, "recompute", False) and not is_test:
        raise NotImplementedError("per-layer rematerialization "
                                  "(layers.recompute) is not ported yet "
                                  "(ROADMAP A9)")
    fused = getattr(hp, "fused_attn", False)
    src_kpad = cross_kpad = None
    if fused:
        src_len = int(src_slf_attn_bias.shape[-1])
        src_kpad = layers.reshape(src_slf_attn_bias, [-1, src_len])
        cross_kpad = layers.reshape(trg_src_attn_bias, [-1, src_len])
        if trg_kpad_bias is None:
            raise ValueError("hp.fused_attn requires trg_kpad_bias")
    x = prepare_embedding(src_ids, hp.src_vocab_size, hp.d_model,
                          hp.max_length, hp.dropout, "src_pos_enc_table",
                          is_test)
    for _ in range(hp.n_layer):
        x = encoder_layer(x, src_slf_attn_bias, hp, is_test,
                          kpad_bias=src_kpad)
    enc_out = x
    y = prepare_embedding(trg_ids, hp.trg_vocab_size, hp.d_model,
                          hp.max_length, hp.dropout, "trg_pos_enc_table",
                          is_test)
    for _ in range(hp.n_layer):
        y = decoder_layer(y, enc_out, trg_slf_attn_bias, trg_src_attn_bias,
                          hp, is_test, self_kpad=trg_kpad_bias,
                          cross_kpad=cross_kpad)
    return layers.fc(y, size=hp.trg_vocab_size, num_flatten_dims=2,
                     bias_attr=False, param_attr=_pa("softmax_out.w"))


def wmt_transformer_program(hp=ModelHyperParams, src_len=64, trg_len=64,
                            learning_rate=2.0, warmup_steps=4000,
                            is_test=False, use_bf16=False, mesh=None):
    """(main, startup, feed names, [avg_cost, token_count]) for training:
    label-smoothed cross entropy over the padded target tokens, noam lr,
    Adam(0.9, 0.997, 1e-9).  The loss chain is folded by
    smooth_label_xent_fuse_pass into linear_xent_fuse_pass (the [R, V]
    logits never exist), and the FFN / residual-LN chains by
    matmul_epilogue_fuse_pass, before minimize; use_bf16 then applies
    bf16_amp_pass (bf16 products, float32 master weights and Adam
    state), as the reference does.  The reference's rematerialization
    hook emits nothing without its HBM-budget flag
    (FLAGS_hbm_budget_bytes, 0 by default), and its pass is not ported
    yet (ROADMAP A9), so nothing is emitted here either."""
    from .. import optimizer
    from ..transpiler.pass_registry import apply_pass

    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup), unique_name.guard():
        src = layers.data("src_word", shape=[src_len], dtype="int64")
        trg = layers.data("trg_word", shape=[trg_len], dtype="int64")
        lbl = layers.data("lbl_word", shape=[trg_len], dtype="int64")
        src_bias = layers.data("src_slf_attn_bias", shape=[1, 1, src_len],
                               dtype="float32")
        trg_bias = layers.data("trg_slf_attn_bias",
                               shape=[1, trg_len, trg_len], dtype="float32")
        cross_bias = layers.data("trg_src_attn_bias", shape=[1, 1, src_len],
                                 dtype="float32")
        weights = layers.data("lbl_weight", shape=[trg_len], dtype="float32")
        trg_kpad = None
        if getattr(hp, "fused_attn", False):
            trg_kpad = layers.scale(weights, scale=1e9, bias=-1e9)
            trg_kpad.stop_gradient = True
        logits = transformer(src, trg, src_bias, trg_bias, cross_bias, hp,
                             is_test, trg_kpad_bias=trg_kpad)
        label_oh = layers.one_hot(lbl, hp.trg_vocab_size)
        if hp.label_smooth_eps:
            label_oh = layers.label_smooth(label_oh,
                                           epsilon=hp.label_smooth_eps)
        cost = layers.softmax_with_cross_entropy(logits, label_oh,
                                                 soft_label=True)
        weighted = layers.elementwise_mul(cost, layers.unsqueeze(weights, [2]))
        sum_cost = layers.reduce_sum(weighted)
        token_count = layers.reduce_sum(weights)
        avg_cost = layers.elementwise_div(sum_cost, token_count)
        apply_pass(main, "smooth_label_xent_fuse_pass")
        apply_pass(main, "linear_xent_fuse_pass")
        apply_pass(main, "matmul_epilogue_fuse_pass")
        if use_bf16:
            apply_pass(main, "bf16_amp_pass")
        if not is_test:
            lr = layers.learning_rate_scheduler.noam_decay(hp.d_model,
                                                           warmup_steps)
            lr = layers.scale(lr, scale=float(learning_rate))
            opt = optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                                 epsilon=1e-9)
            opt.minimize(avg_cost)
    if mesh is not None:
        # the training stamp: the family's rules lifted to training names
        # (grads and Adam moments follow their param); the executor runs
        # the vocab projection's slab and raises for what is not ported
        from ..parallel.partition_rules import (annotate_spmd,
                                                train_partition_rules_for)

        annotate_spmd(main, mesh, train_partition_rules_for(
            getattr(hp, "partition_family", "transformer")))
    feeds = ["src_word", "trg_word", "lbl_word", "src_slf_attn_bias",
             "trg_slf_attn_bias", "trg_src_attn_bias", "lbl_weight"]
    return main, startup, feeds, [avg_cost, token_count]


NEG_BIAS = -1e9  # the "masked" sentinel of the train and inference masks


def pad_bias(lens, max_len):
    """[B] lengths -> [B, 1, 1, max_len] additive key-padding bias."""
    lens = np.asarray(lens).reshape(-1)
    pad = np.arange(max_len)[None, :] >= lens[:, None]
    return np.where(pad, NEG_BIAS, 0.0).astype("float32")[:, None, None, :]


def causal_plus_pad_bias(lens, max_len):
    """[B] lengths -> [B, 1, T, T] causal + key-padding decoder bias."""
    lens = np.asarray(lens).reshape(-1)
    causal = np.triu(np.ones((max_len, max_len)), k=1) * NEG_BIAS
    pad = np.arange(max_len)[None, :] >= lens[:, None]
    bias = np.where(pad[:, None, :], NEG_BIAS, 0.0) + causal[None, :, :]
    return bias[:, None, :, :].astype("float32")


def make_fake_batch(batch_size, src_len, trg_len, hp=ModelHyperParams,
                    seed=0):
    """A seeded synthetic padded batch with its masks (host side)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, hp.src_vocab_size, (batch_size, src_len)).astype("int64")
    trg = rng.randint(1, hp.trg_vocab_size, (batch_size, trg_len)).astype("int64")
    lbl = rng.randint(1, hp.trg_vocab_size, (batch_size, trg_len)).astype("int64")
    src_lens = rng.randint(src_len // 2, src_len + 1, (batch_size,))
    trg_lens = rng.randint(trg_len // 2, trg_len + 1, (batch_size,))
    weights = (np.arange(trg_len)[None, :] < trg_lens[:, None]).astype("float32")
    return {
        "src_word": src,
        "trg_word": trg,
        "lbl_word": lbl,
        "src_slf_attn_bias": pad_bias(src_lens, src_len),
        "trg_slf_attn_bias": causal_plus_pad_bias(trg_lens, trg_len),
        "trg_src_attn_bias": pad_bias(src_lens, src_len),
        "lbl_weight": weights,
    }


def transformer_logits_program(hp=ModelHyperParams, src_len=64, trg_len=64):
    """Inference program fetching the [B, Tt, trg_vocab] logits, the
    full re-decode loops' step.  Built under unique_name.guard(), so it
    shares weights by name with wmt_transformer_program."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup), unique_name.guard():
        src = layers.data("src_word", shape=[src_len], dtype="int64")
        trg = layers.data("trg_word", shape=[trg_len], dtype="int64")
        src_bias = layers.data("src_slf_attn_bias", shape=[1, 1, src_len],
                               dtype="float32")
        trg_bias = layers.data("trg_slf_attn_bias",
                               shape=[1, trg_len, trg_len], dtype="float32")
        cross_bias = layers.data("trg_src_attn_bias", shape=[1, 1, src_len],
                                 dtype="float32")
        trg_kpad = None
        if getattr(hp, "fused_attn", False):
            # the dense decoder bias's last causal row is pure key padding
            # (causality adds 0 there): the rank-1 bias of the fused path
            last_row = layers.slice(trg_bias, axes=[2], starts=[trg_len - 1],
                                    ends=[trg_len])
            trg_kpad = layers.reshape(last_row, [-1, trg_len])
            trg_kpad.stop_gradient = True
        logits = transformer(src, trg, src_bias, trg_bias, cross_bias, hp,
                             is_test=True, trg_kpad_bias=trg_kpad)
    feeds = ["src_word", "trg_word", "src_slf_attn_bias",
             "trg_slf_attn_bias", "trg_src_attn_bias"]
    return main, startup, feeds, [logits]


def _translate_prologue(main, src_ids, src_lens, max_out_len):
    """The full re-decode loops' prologue: the program's widths, the
    source checked against them, its padding bias."""
    blk = main.global_block()
    src_len = int(blk.vars["src_word"].shape[1])
    trg_len = int(blk.vars["trg_word"].shape[1])
    max_out_len = min(max_out_len or trg_len, trg_len)
    src_ids = np.asarray(src_ids, "int64")
    b, p = src_ids.shape
    assert p == src_len, "src must be padded to the program's %d" % src_len
    src_lens = np.asarray(src_lens).reshape(-1)
    return (src_ids, src_lens, pad_bias(src_lens, src_len), trg_len,
            max_out_len, b)


def greedy_translate(exe, main, fetches, src_ids, src_lens, bos_id, eos_id,
                     max_out_len=None, pad_id=0):
    """Greedy decoding on transformer_logits_program: every step re-runs
    the whole fixed-shape program and reads the logits at the last real
    position (causal masking hides the padded target tail).  src_ids
    [B, Ts] int64, src_lens [B]; returns [B, T_out] int64 rows starting
    with bos_id, stopping once every row has emitted eos_id."""
    src_ids, src_lens, src_bias, trg_len, max_out_len, b = \
        _translate_prologue(main, src_ids, src_lens, max_out_len)
    trg = np.full((b, trg_len), pad_id, "int64")
    trg[:, 0] = bos_id
    done = np.zeros(b, bool)
    cur = 1
    while cur < max_out_len and not done.all():
        feed = {
            "src_word": src_ids,
            "trg_word": trg,
            "src_slf_attn_bias": src_bias,
            "trg_slf_attn_bias": causal_plus_pad_bias(np.full(b, cur),
                                                      trg_len),
            "trg_src_attn_bias": src_bias,
        }
        (logits,) = exe.run(main, feed=feed, fetch_list=fetches)
        nxt = np.asarray(logits)[:, cur - 1, :].argmax(axis=-1)
        nxt = np.where(done, pad_id, nxt)
        trg[:, cur] = nxt
        done |= nxt == eos_id
        cur += 1
    return trg[:, :cur]


def beam_translate(exe, main, fetches, src_ids, src_lens, bos_id, eos_id,
                   beam_size=4, max_out_len=None, pad_id=0,
                   length_penalty=0.0):
    """Beam-search decoding on transformer_logits_program (the feed
    contract of greedy_translate).  Returns (ids [B, T_out], scores
    [B])."""
    from ..contrib.decoder.beam_search_decoder import full_sequence_beam_search

    src_ids, src_lens, src_bias, trg_len, max_out_len, b = \
        _translate_prologue(main, src_ids, src_lens, max_out_len)
    src_rep = np.repeat(src_ids, beam_size, axis=0)
    src_bias_rep = np.repeat(src_bias, beam_size, axis=0)
    trg0 = np.full((b, trg_len), pad_id, "int64")
    trg0[:, 0] = bos_id

    def logits_fn(rows, cur):
        feed = {
            "src_word": src_rep,
            "trg_word": rows,
            "src_slf_attn_bias": src_bias_rep,
            "trg_slf_attn_bias": causal_plus_pad_bias(
                np.full(rows.shape[0], cur), trg_len),
            "trg_src_attn_bias": src_bias_rep,
        }
        (logits,) = exe.run(main, feed=feed, fetch_list=fetches)
        return np.asarray(logits)[:, cur - 1, :]

    return full_sequence_beam_search(logits_fn, trg0, 1, beam_size,
                                     max_out_len, eos_id, pad_id,
                                     length_penalty)


def transformer_decode_programs(hp=ModelHyperParams, batch=1, src_len=64,
                                t_max=None, width=1):
    """KV-cached seq2seq decoding as three programs over one scope's
    persistable state (weights shared by name with
    wmt_transformer_program and transformer_logits_program):

      enc_main:  feeds src_word [B, Ts] and src_slf_attn_bias
                 [B, 1, 1, Ts]; runs the encoder once and persists
                 tfm_enc_out_cache [B, Ts, D] and the cross-attention
                 key-padding row tfm_cross_kpad_cache [B, Ts];
      step_main: feeds trg_tok [B, W] and pos [1] (and pos_vec [W] when
                 W > 1); one cached decoder step (self-attention over
                 the per-layer tfm_{k,v}cache_<i>, offset-causal when
                 W > 1, and W-query cross-attention over the persisted
                 enc_out); fetches logits [B, trg_vocab] (W 1) or
                 [B, W, trg_vocab];
      cache_startup: zeroes all of that state.

    A token costs O((t_max + Ts) d) instead of the full re-decode's
    O(t_max^2 d); W > 1 scores W known target positions a dispatch (the
    rescoring step of force_decode_logits_cached).  Returns (enc_main,
    step_main, cache_startup, enc_feeds, step_feeds, enc_fetch,
    step_fetch)."""
    from .decode_cache import add_cache_zero_fills, create_kv_caches

    t_max = t_max or hp.max_length
    assert t_max <= hp.max_length, (
        "t_max %d exceeds hp.max_length %d" % (t_max, hp.max_length))
    width = int(width)
    assert 1 <= width <= t_max, (width, t_max)
    dh = hp.d_model // hp.n_head
    enc_main = framework.Program()
    step_main = framework.Program()
    cache_startup = framework.Program()
    throwaway = framework.Program()  # weights come by name

    with unique_name.guard():
        # the encoder program: the source embedding and encoder layers
        with framework.program_guard(enc_main, throwaway):
            src = layers.data("src_word", shape=[batch, src_len],
                              dtype="int64", append_batch_size=False)
            src_bias = layers.data(
                "src_slf_attn_bias", shape=[batch, 1, 1, src_len],
                dtype="float32", append_batch_size=False)
            src_kpad = layers.reshape(src_bias, [-1, src_len])
            x = prepare_embedding(src, hp.src_vocab_size, hp.d_model,
                                  hp.max_length, 0.0, "src_pos_enc_table",
                                  is_test=True)
            for _ in range(hp.n_layer):
                x = encoder_layer(x, src_bias, hp, is_test=True,
                                  kpad_bias=src_kpad)
            eb = enc_main.global_block()
            enc_cache = eb.create_var(
                name="tfm_enc_out_cache", shape=[batch, src_len, hp.d_model],
                dtype="float32", persistable=True)
            kpad_cache = eb.create_var(
                name="tfm_cross_kpad_cache", shape=[batch, src_len],
                dtype="float32", persistable=True)
            eb.append_op("assign", inputs={"X": [x]},
                         outputs={"Out": [enc_cache]})
            eb.append_op("assign", inputs={"X": [src_kpad]},
                         outputs={"Out": [kpad_cache]})

        # the step program: names continue with the target embedding and
        # the decoder layers
        with framework.program_guard(step_main, throwaway):
            tok = layers.data("trg_tok", shape=[batch, width], dtype="int64",
                              append_batch_size=False)
            pos = layers.data("pos", shape=[1], dtype="int64",
                              append_batch_size=False)
            pos_vec = None
            if width > 1:
                pos_vec = layers.data("pos_vec", shape=[width],
                                      dtype="int64", append_batch_size=False)
            word = layers.embedding(
                tok, size=[hp.trg_vocab_size, hp.d_model],
                param_attr=ParamAttr(
                    initializer=Normal(0.0, hp.d_model ** -0.5)),
            )  # [B, W, D] (W 1 squeezes in the lookup)
            word = layers.scale(
                layers.reshape(word, shape=[batch, width, hp.d_model]),
                scale=hp.d_model ** 0.5)
            pos_table = layers.create_parameter(
                shape=[hp.max_length, hp.d_model], dtype="float32",
                name="trg_pos_enc_table",
                attr=ParamAttr(name="trg_pos_enc_table", trainable=False,
                               initializer=NumpyArrayInitializer(
                                   _pos_encoding_table(hp.max_length,
                                                       hp.d_model))))
            if width == 1:
                pos_row = layers.reshape(layers.gather(pos_table, pos),
                                         shape=[1, 1, hp.d_model])
                y = layers.elementwise_add(word, pos_row)
            else:
                pos_rows = layers.gather(pos_table, pos_vec)  # [W, D]
                y = layers.elementwise_add(word, pos_rows, axis=1)
            sb = step_main.global_block()
            enc_ref = sb.create_var(
                name="tfm_enc_out_cache", shape=[batch, src_len, hp.d_model],
                dtype="float32", persistable=True)
            kpad_ref = sb.create_var(
                name="tfm_cross_kpad_cache", shape=[batch, src_len],
                dtype="float32", persistable=True)
            cache_names = ["tfm_enc_out_cache", "tfm_cross_kpad_cache"]
            kv_caches, kv_names = create_kv_caches(
                sb, "tfm", hp.n_layer, batch, hp.n_head, t_max, dh)
            cache_names += kv_names
            for cache in kv_caches:
                cache["pos"] = pos
                if pos_vec is not None:
                    cache["pos_vec"] = pos_vec
                y = decoder_layer(y, enc_ref, None, None, hp, is_test=True,
                                  cross_kpad=kpad_ref, cache=cache)
            logits = layers.fc(y, size=hp.trg_vocab_size, num_flatten_dims=2,
                               bias_attr=False,
                               param_attr=_pa("softmax_out.w"))
            if width == 1:
                logits = layers.reshape(logits,
                                        shape=[batch, hp.trg_vocab_size])

        # the zeroing program
        add_cache_zero_fills(cache_startup, [
            (cname, (enc_main.global_block()._find_var_recursive(cname)
                     or sb._find_var_recursive(cname)).shape)
            for cname in cache_names])

    step_feeds = ["trg_tok", "pos"] + (["pos_vec"] if width > 1 else [])
    return (enc_main, step_main, cache_startup,
            ["src_word", "src_slf_attn_bias"], step_feeds,
            ["tfm_enc_out_cache"], [logits])


def _run_encoder(exe, enc_main, src_ids, src_lens, repeat=1):
    """Run the encoder once: its persistable writes survive with no
    fetch (fetching the [B, Ts, D] activation would be a wasted copy).
    repeat > 1 replicates each source row for the beams."""
    src_bias = pad_bias(src_lens, src_ids.shape[1])
    if repeat > 1:
        src_ids = np.repeat(src_ids, repeat, axis=0)
        src_bias = np.repeat(src_bias, repeat, axis=0)
    exe.run(enc_main, feed={"src_word": src_ids,
                            "src_slf_attn_bias": src_bias}, fetch_list=[])


def force_decode_logits_cached(exe, programs, src_ids, src_lens, trg_ids):
    """Teacher-forced scoring through the cached decoder: the encoder
    once, then the given target tokens in ceil(T/W) width-W dispatches
    (programs from transformer_decode_programs(width=W)).  Returns
    [B, T, V] logits, row t the next-token distribution after
    trg_ids[:, t]: a hypothesis's log-probability without a token loop.
    The last chunk re-anchors inside the cache bound (rewriting
    identical slots is idempotent)."""
    from .decode_cache import probe_cache_len, run_chunked_ids

    (enc_main, step_main, cache_startup, _enc_feeds, step_feeds,
     _enc_fetch, step_fetch) = programs
    src_ids = np.asarray(src_ids, "int64")
    trg_ids = np.asarray(trg_ids, "int64")
    b, T = trg_ids.shape
    sb = step_main.global_block()
    step_b, width = (int(sb.vars["trg_tok"].shape[0]),
                     int(sb.vars["trg_tok"].shape[1]))
    assert b == step_b, (b, step_b)
    t_max = probe_cache_len(step_main, "tfm")
    assert T <= t_max, (T, t_max)
    src_lens = np.asarray(src_lens).reshape(-1)

    exe.run(cache_startup)
    _run_encoder(exe, enc_main, src_ids, src_lens)
    out = None
    for c0, lg in run_chunked_ids(exe, step_main, step_fetch, trg_ids,
                                  width, t_max, "trg_tok",
                                  has_pos_vec="pos_vec" in step_feeds):
        lg = lg.reshape(b, width, -1)
        if out is None:
            out = np.zeros((b, T, lg.shape[-1]), lg.dtype)
        hi = min(c0 + width, T)
        out[:, c0:hi] = lg[:, :hi - c0]
    return out


def _translate_cached_loop(exe, programs, src_ids, src_lens, bos_id,
                           eos_id, max_out_len, pad_id, pick_fn):
    """The cached loops' driver: check, zero the caches, run the encoder
    once, then step the cached decoder; pick_fn(logits [B, V]) -> [B]
    chooses each next token (argmax or a sampler)."""
    from .decode_cache import probe_cache_len

    (enc_main, step_main, cache_startup, _enc_feeds, _step_feeds,
     _enc_fetch, step_fetch) = programs
    src_ids = np.asarray(src_ids, "int64")
    b, _ = src_ids.shape
    step_b = int(step_main.global_block().vars["trg_tok"].shape[0])
    assert b == step_b, (
        "src batch %d != decode programs' static batch %d" % (b, step_b))
    t_max = probe_cache_len(step_main, "tfm")
    max_out_len = min(max_out_len or t_max, t_max)
    src_lens = np.asarray(src_lens).reshape(-1)

    exe.run(cache_startup)
    _run_encoder(exe, enc_main, src_ids, src_lens)
    trg = np.full((b, max_out_len), pad_id, "int64")
    trg[:, 0] = bos_id
    done = np.zeros(b, bool)
    cur = 1
    while cur < max_out_len and not done.all():
        (logits,) = exe.run(step_main, feed={
            "trg_tok": trg[:, cur - 1:cur],
            "pos": np.array([cur - 1], "int64"),
        }, fetch_list=step_fetch)
        nxt = np.where(done, pad_id, pick_fn(logits))
        trg[:, cur] = nxt
        done |= nxt == eos_id
        cur += 1
    return trg[:, :cur]


def greedy_translate_cached(exe, programs, src_ids, src_lens, bos_id, eos_id,
                            max_out_len=None, pad_id=0):
    """Greedy decoding through the KV-cached decode programs (the output
    contract of greedy_translate at O((t_max + Ts) d) a token).
    `programs` is transformer_decode_programs' tuple."""
    return _translate_cached_loop(
        exe, programs, src_ids, src_lens, bos_id, eos_id, max_out_len,
        pad_id, lambda lg: np.asarray(lg).argmax(axis=-1).astype("int64"))


def beam_translate_cached(exe, programs, src_ids, src_lens, bos_id, eos_id,
                          beam_size=4, max_out_len=None, pad_id=0,
                          length_penalty=0.0):
    """Beam-search decoding through the KV-cached decode programs (built
    with batch = B * beam_size).  The self-attention caches follow the
    surviving beams through a reorder program every step; the encoder
    state is beam-replicated at encode time and invariant under it.
    Output contract of beam_translate: (ids [B, T_out], scores [B])."""
    from ..contrib.decoder.beam_search_decoder import incremental_beam_search
    from .decode_cache import make_cache_reorder_program, probe_cache_len

    (enc_main, step_main, cache_startup, _enc_feeds, _step_feeds,
     _enc_fetch, step_fetch) = programs
    src_ids = np.asarray(src_ids, "int64")
    b, _ = src_ids.shape
    sb = step_main.global_block()
    r = int(sb.vars["trg_tok"].shape[0])
    assert r == b * beam_size, (
        "decode programs' batch %d != src batch %d * beam %d"
        % (r, b, beam_size))
    t_max = probe_cache_len(step_main, "tfm")
    max_out_len = min(max_out_len or t_max, t_max)
    src_lens = np.asarray(src_lens).reshape(-1)

    exe.run(cache_startup)
    _run_encoder(exe, enc_main, src_ids, src_lens, repeat=beam_size)
    # only the per-layer self-attention caches follow the beams; the
    # reorder program is built once a step program, so a second beam
    # translate through one executor runs only keys it has compiled
    reorder = getattr(step_main, "_tfm_beam_reorder", None)
    if reorder is None:
        reorder = step_main._tfm_beam_reorder = make_cache_reorder_program(
            [(n, v.shape) for n, v in sb.vars.items()
             if n.startswith(("tfm_kcache_", "tfm_vcache_"))], r)

    bos = np.full((r, 1), bos_id, "int64")
    (first,) = exe.run(step_main, feed={
        "trg_tok": bos, "pos": np.array([0], "int64")}, fetch_list=step_fetch)

    def step_fn(tokens, pos):
        (lg,) = exe.run(step_main, feed={
            "trg_tok": tokens, "pos": np.array([pos], "int64")},
            fetch_list=step_fetch)
        return lg

    def reorder_fn(rows):
        exe.run(reorder, feed={"parents": rows.astype("int64")},
                fetch_list=[])

    prompt = np.full((b, 1), bos_id, "int64")
    return incremental_beam_search(step_fn, reorder_fn, first, prompt, 1,
                                   beam_size, max_out_len, eos_id, pad_id,
                                   length_penalty)


def sample_translate_cached(exe, programs, src_ids, src_lens, bos_id,
                            eos_id, max_out_len=None, temperature=1.0,
                            top_k=0, top_p=1.0, seed=None, pad_id=0):
    """Stochastic seq2seq decoding through the KV-cached programs:
    temperature, top-k and nucleus filtering with seeded host numpy
    draws (the sampling twin of greedy_translate_cached)."""
    from .decode_cache import sample_from_logits

    rng = np.random.RandomState(seed)
    return _translate_cached_loop(
        exe, programs, src_ids, src_lens, bos_id, eos_id, max_out_len,
        pad_id,
        lambda lg: sample_from_logits(lg, rng, temperature, top_k, top_p))
