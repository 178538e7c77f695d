"""Tensor creation / manipulation op lowerings (the counterpart of
``paddle_tpu/ops/tensor_ops.py``), limited to the ops the serving slice,
the GPT-2 programs (grouped-query attention's ``expand`` included), the
WMT Transformer's training step, BERT pretraining (``squeeze2``), the
GRU seq2seq model (``concat``), the packed causal LM (``cast``) and
DeepFM (the sparse embedding gradient, ``lookup_table_grad``) run.
Random ops draw from the run's seeded ``torch.Generator``
(``LowerCtx.rng``).
"""

import math

import numpy as np
import torch

from ..core.registry import lower_grad_op, register
from ..core.selected_rows import SelectedRows
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
    """The attr's values as a tensor.  They reach the device once per
    cache entry (``LowerCtx.constant``); each run returns a copy, so no
    later op's in-place write reaches the constant."""

    def make():
        vals = np.array(attrs["values"],
                        dtype=np.dtype(attrs.get("np_dtype", "float32")))
        if attrs.get("shape"):
            vals = vals.reshape(attrs["shape"])
        out = torch.from_numpy(vals).to(tdt(str(vals.dtype)))
        return out.to(_device(ctx))

    return {"Out": [ctx.constant(make).clone()]}


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


@register("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, ins, attrs):
    """A normal draw truncated to [-2, 2] standard deviations, then
    scaled and shifted: the reference's jax.random.truncated_normal, by
    the same inverse-CDF method (a uniform draw between the bounds'
    erf values, through erfinv), from ctx.rng's generator.  The two
    frameworks' streams differ: the samples match in distribution."""
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(_shape(attrs), generator=ctx.rng(attrs),
                   dtype=torch.float32, device=_device(ctx))
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    z = torch.clamp(z, math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))
    return {"Out": [(z * std + mean).to(tdt(attrs.get("dtype",
                                                      "float32")))]}


@register("assign")
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register("cast")
def _cast(ctx, ins, attrs):
    """X to out_dtype.  A float-to-float cast takes its gradient through
    the generic vjp; a bool or int X takes none (not a float input)."""
    return {"Out": [ins["X"][0].to(tdt(attrs["out_dtype"]))]}


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


@register("squeeze2")
def _squeeze(ctx, ins, attrs):
    """Drop unit axes: every one for empty `axes`, else those listed
    (negative ones wrap); a listed axis that is not of size 1 raises,
    as jnp.squeeze does in the reference."""
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": [x.squeeze()]}
    dims = sorted({int(a) % x.dim() for a in axes})
    if any(x.shape[d] != 1 for d in dims):
        raise ValueError("squeeze: axes %s of shape %s are not all of size 1"
                         % (list(axes), tuple(x.shape)))
    return {"Out": [x.squeeze(tuple(dims))]}


@register("unsqueeze2")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": [x]}


@register("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


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


class _Embedding(torch.autograd.Function):
    """Embedding rows whose backward sums each row's gradients in one
    fixed order on every device, so a training step is bit-reproducible
    from the same state: ``index_put`` with ``accumulate`` sorts the ids
    and sums each run of equal ids in order.  PyTorch's own CUDA
    backward of ``F.embedding`` is not reproducible once more than 3072
    ids hold a row thousands of times (BERT's 2-row segment table over
    32 x 128 tokens: two runs differed by 6e-5 on an H100), and
    ``index_select``'s backward scatters with float atomics."""

    @staticmethod
    def forward(ids, w):
        return torch.nn.functional.embedding(ids, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ids, w = inputs
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        h = dout.shape[-1]
        dw = dout.new_zeros((ctx.rows, h)).index_put(
            (ids.reshape(-1),), dout.reshape(-1, h), accumulate=True)
        return None, dw


@register("gather", no_grad_inputs=("Index",))
def _gather(ctx, ins, attrs):
    """Rows of X at Index along `axis`.  Along axis 0 (the position
    tables' gather) the rows go through ``_Embedding``, whose backward
    sums repeated indices in a fixed order, so a training step is
    bit-reproducible on the card."""
    x, idx = ins["X"][0], ins["Index"][0]
    axis = attrs.get("axis", 0)
    idx = idx.reshape(-1).long()
    if axis == 0:
        out = _Embedding.apply(idx, x.reshape(x.shape[0], -1))
    else:
        out = x.index_select(axis, idx)
    shape = list(x.shape[:axis]) + list(ins["Index"][0].shape) + list(
        x.shape[axis + 1:])
    return {"Out": [out.reshape(shape)]}


def _ids(ins):
    ids = ins["Ids"][0].long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return ids


@register("lookup_table", no_grad_inputs=("Ids",))
@register("lookup_table_v2", no_grad_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs):
    """Embedding rows, with a reproducible backward (``_Embedding``)."""
    w, ids = ins["W"][0], _ids(ins)
    out = _Embedding.apply(ids, w)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out * (ids != pad).to(out.dtype)[..., None]
    return {"Out": [out]}


@register("lookup_table_grad", handles_selected_rows=True)
@register("lookup_table_v2_grad", handles_selected_rows=True)
def _lookup_table_grad(ctx, ins, attrs):
    """The embedding's gradient.  With ``is_sparse`` it is a
    SelectedRows: the ids as rows, Out@GRAD's rows as values, the
    ``padding_idx`` rows zeroed, never a [vocab, dim] tensor (the
    reference's hand rule, ``paddle_tpu/ops/tensor_ops.py:331``).
    Otherwise the generic vjp, ``_Embedding``'s dense backward."""
    fwd_attrs = attrs.get("__fwd_attrs__", {})
    if not fwd_attrs.get("is_sparse", False):
        return lower_grad_op(ctx, ins, attrs)
    w, og = ins["W"][0], ins["Out@GRAD"][0]
    rows = _ids(ins).reshape(-1)
    vals = og.reshape(-1, og.shape[-1]).to(w.dtype)
    pad = fwd_attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        vals = torch.where((rows == pad)[:, None], torch.zeros_like(vals),
                           vals)
    return {"W@GRAD": [SelectedRows(rows, vals, w.shape[0])]}


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
    return {"Out": [x + torch.full((), attrs.get("step", 1.0), dtype=x.dtype,
                                   device=x.device)]}
