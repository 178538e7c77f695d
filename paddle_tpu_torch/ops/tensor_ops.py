"""Tensor creation / manipulation op lowerings (the counterpart of
``paddle_tpu/ops/tensor_ops.py``), limited to the ops the serving slice,
the GPT-2 programs (grouped-query attention's ``expand`` included) and
the WMT Transformer's training step run.  Random ops draw from the run's
seeded ``torch.Generator`` (``LowerCtx.rng``).
"""

import numpy as np
import torch

from ..core.registry import register
from .common import tdt


def _shape(attrs):
    return tuple(int(s) for s in attrs["shape"])


def _device(ctx):
    return ctx.device if ctx.device is not None else torch.device("cpu")


@register("fill_constant")
def _fill_constant(ctx, ins, attrs):
    return {"Out": [torch.full(_shape(attrs), float(attrs.get("value", 0.0)),
                               dtype=tdt(attrs.get("dtype", "float32")),
                               device=_device(ctx))]}


@register("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register("assign_value")
def _assign_value(ctx, ins, attrs):
    vals = np.array(attrs["values"],
                    dtype=np.dtype(attrs.get("np_dtype", "float32")))
    if attrs.get("shape"):
        vals = vals.reshape(attrs["shape"])
    out = torch.from_numpy(vals).to(tdt(str(vals.dtype)))
    return {"Out": [out.to(_device(ctx))]}


@register("uniform_random")
def _uniform_random(ctx, ins, attrs):
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    out = torch.rand(_shape(attrs), generator=ctx.rng(attrs),
                     dtype=torch.float32, device=_device(ctx))
    return {"Out": [(out * (hi - lo) + lo).to(tdt(attrs.get("dtype",
                                                           "float32")))]}


@register("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    out = torch.randn(_shape(attrs), generator=ctx.rng(attrs),
                      dtype=torch.float32, device=_device(ctx))
    return {"Out": [(out * std + mean).to(tdt(attrs.get("dtype",
                                                       "float32")))]}


@register("assign")
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


def _resolve_reshape(x, shape):
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return tuple(shape)


@register("reshape2")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(_resolve_reshape(x, attrs["shape"]))]}


@register("transpose2")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register("unsqueeze2")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": [x]}


@register("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": [out]}


@register("expand")
def _expand(ctx, ins, attrs):
    """Tile X expand_times along each axis (jnp.tile's semantics): GQA's
    repeat_kv tiles each kv head over its query group."""
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register("gather", no_grad_inputs=("Index",))
def _gather(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    axis = attrs.get("axis", 0)
    out = x.index_select(axis, idx.reshape(-1).long())
    shape = list(x.shape[:axis]) + list(idx.shape) + list(x.shape[axis + 1:])
    return {"Out": [out.reshape(shape)]}


@register("lookup_table", no_grad_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs):
    """Embedding rows.  ``F.embedding`` rather than ``index_select``: its
    CUDA backward sums each row's gradients in a sorted, fixed order
    (index_select's scatters with float atomics), so a training step is
    bit-reproducible from the same state."""
    w, ids = ins["W"][0], ins["Ids"][0].long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    out = torch.nn.functional.embedding(ids, w)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out * (ids != pad).to(out.dtype)[..., None]
    return {"Out": [out]}


@register("one_hot", no_grad_inputs=("X",))
def _one_hot(ctx, ins, attrs):
    """float32 one-hot rows; an id outside [0, depth) gives a zero row
    (the reference's jax.nn.one_hot convention)."""
    x = ins["X"][0].long()
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    depth = int(attrs["depth"])
    cols = torch.arange(depth, device=x.device)
    return {"Out": [(x[..., None] == cols).to(torch.float32)]}


@register("increment")
def _increment(ctx, ins, attrs):
    """x + step in x's dtype.  The op overwrites its input var (the lr
    schedule's step counter), so the runner keeps the input as it was
    where a grad op re-runs it."""
    x = ins["X"][0]
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                     device=x.device)]}
