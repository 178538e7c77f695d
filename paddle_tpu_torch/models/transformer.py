"""Transformer building blocks (the counterpart of
``paddle_tpu/models/transformer.py``): ``multi_head_attention``'s fused,
ragged-cache path, the attention of the continuous-batching serving
step.  Parameter names (mha_q.w / mha_k.w / mha_v.w / mha_o.w) are the
reference's."""

from .. import layers, unique_name
from ..param_attr import ParamAttr

__all__ = ["multi_head_attention"]


def _pa(base):
    return ParamAttr(name=unique_name.generate(base))


def multi_head_attention(queries, keys, values, attn_bias, d_model, n_head,
                         dropout_rate=0.0, is_test=False, cache=None,
                         fused=False, kpad_bias=None, causal=False,
                         n_kv_head=None, rotary=False):
    """All heads in one q/k/v projection each, then fused attention.

    Ported form: the RAGGED cache mode of the serving step — a cache
    dict carrying "k"/"v" [B, H, T_max, Dh] persistables plus
    "pos_rows" [B] and "width_rows" [B].  Each batch row writes its K/V
    at its own position with its own valid width (slot_cache_write) and
    attends with its own offset-causal cutoff (fused_attention with a
    vector qstart).  The other forms of the reference (unfused, the
    scalar-pos decode step, grouped-query attention, rotary positions)
    arrive with their slices and raise here."""
    if n_kv_head is not None and n_kv_head < n_head:
        raise NotImplementedError("grouped-query attention (n_kv_head < "
                                  "n_head) is not ported yet (ROADMAP A5)")
    if rotary:
        raise NotImplementedError("rotary positions are not ported yet "
                                  "(ROADMAP A5)")
    if not fused:
        raise NotImplementedError("the unfused attention path is not ported "
                                  "yet (ROADMAP A3)")
    dh = d_model // n_head
    q = layers.fc(queries, size=d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_pa("mha_q.w"))
    k = layers.fc(keys, size=d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_pa("mha_k.w"))
    v = layers.fc(values, size=d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_pa("mha_v.w"))

    def split_heads(x):
        b, t = x.shape[0], x.shape[1]
        x = layers.reshape(x, [b, t, n_head, dh])
        return layers.transpose(x, [0, 2, 1, 3])  # [B, heads, T, Dh]

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if cache is None:
        if attn_bias is not None and kpad_bias is None:
            raise ValueError(
                "fused attention cannot consume the dense [B,H,Tq,Tk] "
                "attn_bias — pass its rank-1 key-padding row as kpad_bias")
        ctx = layers.fused_attention(q, k, v, bias=kpad_bias, causal=causal,
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
        if "pos_rows" not in cache:
            raise NotImplementedError("the scalar-pos cached decode step is "
                                      "not ported yet (ROADMAP A5)")
        if "width_rows" not in cache:
            raise ValueError("ragged cached attention needs width_rows "
                             "alongside pos_rows (per-row valid write widths)")
        if int(cache["k"].shape[1]) != n_head:
            raise ValueError("cache has %d kv heads but the model has %d"
                             % (int(cache["k"].shape[1]), n_head))
        from ..layer_helper import LayerHelper

        helper = LayerHelper("cached_attention")

        def write_cache(cvar, new):
            out = layers.slot_cache_write(cvar, new, cache["pos_rows"],
                                          cache["width_rows"])
            helper.append_op("assign", inputs={"X": [out]},
                             outputs={"Out": [cvar]})
            return out

        k_full = write_cache(cache["k"], k)
        v_full = write_cache(cache["v"], v)
        ctx = layers.fused_attention(q, k_full, v_full, causal=True,
                                     qstart=cache["pos_rows"],
                                     scale=dh ** -0.5)  # [B, H, W, Dh]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    b, t = ctx.shape[0], ctx.shape[1]
    ctx = layers.reshape(ctx, [b, t, d_model])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=_pa("mha_o.w"))
