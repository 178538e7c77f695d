"""GPT-2-style decoder-only LM (the counterpart of
``paddle_tpu/models/gpt2.py``): ``GPT2Config`` (GPT-2 small by
default), ``gpt2_lm``, ``gpt2_lm_program`` (causal-LM training: forward,
fuse passes, backward, Adam), ``make_fake_lm_batch``,
``gpt2_logits_program`` (its startup initializes the weights) and
``gpt2_ragged_step_program`` (the serving engine's step).  Built under
``unique_name.guard()`` as in the reference, so the parameter names are
the reference's and weights cross between the packages by name
(``paddle_tpu_torch.io.params_from_numpy``).

The modern-decoder options of ``GPT2Config`` are ported: ``n_kv_head``
(grouped-query attention), ``use_rotary`` (RoPE on q and k instead of
the position table), ``use_swiglu`` (the gated SiLU FFN, ``ffn_gate.w``
and ``ffn_up.w`` in place of ``ffn_in.w``, its hidden width 2/3 of 4 d
rounded up to ``ffn_multiple_of``; the matmul_swiglu kernel).  Options
not ported yet raise: ``recompute`` (ROADMAP A9), and
``gpt2_lm_program``'s ``use_bf16`` (A3) and ``mesh`` (A7).
"""

import numpy as np

from .. import framework, layers, unique_name
from ..initializer import Normal
from ..param_attr import ParamAttr

__all__ = ["GPT2Config", "gpt2_lm", "gpt2_lm_program", "make_fake_lm_batch",
           "gpt2_logits_program", "gpt2_ragged_step_program"]


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
    as in the reference.  The reference's rematerialization hook emits
    nothing without its HBM-budget flag, and the port has no flags, so
    it emits nothing here either."""
    if use_bf16:
        raise NotImplementedError("the bf16 AMP rewrite is not ported yet "
                                  "(ROADMAP A3)")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded training is not ported yet "
                                  "(ROADMAP A7)")
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
        if not is_test:
            optimizer.Adam(learning_rate=lr).minimize(loss)
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


def gpt2_ragged_step_program(hp=GPT2Config, batch=4, t_max=None, width=8,
                             cache_prefix="gpt2"):
    """The continuous-batching serving step: width-W decode over a pool
    of `batch` cache slots, each at its own position.

        feeds:  step_ids [B, W] int64, pos_rows [B] int64,
                width_rows [B] int64, pos_mat [B, W] int64
        fetch:  logits [B, W, vocab] — row b column i predicts position
                pos_rows[b] + i + 1
        state:  per-layer <cache_prefix>_{k,v}cache_<i> persistables
                [batch, n_kv_head or n_head, t_max, dh], float32 (the
                kernels take float32; the reference's cache_dtype waits
                for their bf16 forms)

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
            t_max, dh)
        add_cache_zero_fills(
            cache_startup,
            [(n, (batch, n_kv, t_max, dh)) for n in cache_names])
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
