"""Transformer (the counterpart of ``paddle_tpu/models/transformer.py``):
the encoder-decoder Transformer-base of the WMT training program
(``wmt_transformer_program``, label smoothing, noam lr, Adam) and
``multi_head_attention``'s ported forms: the unfused training form
(batched matmul / softmax / dropout), the fused (flash) form, and the
cached forms of the decode step (one token or a chunk at a scalar
position) and of the serving step (ragged), each with grouped-query
attention and rotary positions as options.  Parameter names (mha_q.w
... softmax_out.w) are the reference's, so the programs built here list
the same ops over the same names as the reference's."""

import numpy as np

from .. import layers, unique_name
from ..initializer import Normal, NumpyArrayInitializer
from ..param_attr import ParamAttr

__all__ = ["ModelHyperParams", "multi_head_attention", "transformer",
           "wmt_transformer_program", "make_fake_batch", "pad_bias",
           "causal_plus_pad_bias"]


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
                  self_kpad=None, cross_kpad=None):
    """The training form (the reference's cached decode step is still to
    port)."""
    fused = getattr(hp, "fused_attn", False)
    self_attn = multi_head_attention(
        x, x, x, self_bias, hp.d_model, hp.n_head, hp.dropout, is_test,
        fused=fused, kpad_bias=self_kpad, causal=fused)
    x = pre_post_process(x, self_attn, hp.dropout, is_test)
    cross = multi_head_attention(
        x, enc_out, enc_out, cross_bias, hp.d_model, hp.n_head, hp.dropout,
        is_test, fused=fused, kpad_bias=cross_kpad)
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
                                  "(ROADMAP A3)")
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
    matmul_epilogue_fuse_pass, before minimize.  The reference's
    rematerialization hook emits nothing without its HBM-budget flag,
    and the port has no flags yet, so it emits nothing here either."""
    if use_bf16:
        raise NotImplementedError("the bf16 AMP rewrite is not ported yet "
                                  "(ROADMAP A3)")
    from .. import framework, optimizer
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
