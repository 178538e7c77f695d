"""Sequence layers over the padded + lengths representation (the
counterpart of ``paddle_tpu/layers/sequence.py``), limited to
``sequence_pool`` and its first/last helpers: sequences are padded
[batch, time, ...] tensors with an optional [batch] length tensor, and
masks take the place of LoD offsets.  Without a length, the whole time
axis counts."""

import torch

from ..core.registry import register
from ..layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_first_step", "sequence_last_step"]


def _time_mask(x, seq_len):
    """[B, T] mask in x's dtype: 1 at t < seq_len[b]."""
    ar = torch.arange(x.shape[1], device=x.device)[None, :]
    return (ar < seq_len[:, None]).to(x.dtype)


@register("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    """SUM, AVERAGE, SQRT (sum over sqrt(length)), MAX, LAST and FIRST
    over the valid steps of each row.  MAX puts the dtype's lowest value
    at padded steps and reduces with torch.amax, whose gradient splits a
    tie evenly, as jnp.max's does (torch.max(dim) gives it all to one
    element)."""
    x = ins["X"][0]  # [B, T, ...]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    if seq_len is None:
        mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    else:
        mask = _time_mask(x, seq_len)
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    if ptype == "SUM":
        out = (x * m).sum(1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    elif ptype == "SQRT":
        out = (x * m).sum(1) / torch.sqrt(torch.clamp(m.sum(1), min=1.0))
    elif ptype == "MAX":
        low = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                         device=x.device)
        out = torch.amax(torch.where(m > 0, x, low), dim=1)
    elif ptype == "LAST":
        if seq_len is None:
            out = x[:, -1]
        else:
            idx = torch.clamp(seq_len.long() - 1, min=0)
            idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
                (-1, 1) + tuple(x.shape[2:]))
            out = torch.gather(x, 1, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError("sequence_pool type %s" % ptype)
    return {"Out": [out]}


def sequence_pool(input, pool_type, seq_len=None):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op("sequence_pool", inputs=inputs, outputs={"Out": [out]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, seq_len=None):
    return sequence_pool(input, "FIRST", seq_len)


def sequence_last_step(input, seq_len=None):
    return sequence_pool(input, "LAST", seq_len)
