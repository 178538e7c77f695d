"""Elementwise / activation / matmul / reduction / loss op lowerings
(the counterpart of ``paddle_tpu/ops/math_ops.py``), limited to the ops
the serving slice, the GPT-2 (with its modern-decoder options), WMT
Transformer and BERT pretraining steps, the recurrent models (the
stacked LSTM classifier's cross entropy and accuracy, the GRU seq2seq
model's), the packed causal LM (the compare ops of its loss mask) and
the conv nets (SE-ResNeXt's sigmoid), DeepFM (``pow``; the SelectedRows
branches of ``scale`` and ``sum``) and gradient clipping and
regularization (``clip_by_norm``, ``elementwise_max``, ``sqrt``,
``square``, ``sign``) run, and the rest of the reference's activation
table (``_ACTS``: ``exp``, ``floor``, ``cos`` and the others the
learning-rate schedules and the unary layers of ``layers/ops.py``
emit).  ``mul`` and ``matmul`` are
plain products outside any kernel of the reference, so they stay
``torch.matmul`` here too.
``fused_linear_xent`` sits on the hand-written linear cross-entropy
kernels (``kernels/linear_xent.py``), the hard-label 2-D form of
``softmax_with_cross_entropy`` on the softmax cross-entropy kernels
(``kernels/softmax_xent.py``).
"""

import torch

from ..core.registry import register
from ..core.selected_rows import SelectedRows, densify_maybe
from ..kernels import fused_linear_xent, fused_softmax_xent
from .common import bcast_y
from .spmd_epilogue import spmd_linear_xent


def _elementwise(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        out = fn(x, bcast_y(x, y, attrs.get("axis", -1)))
        scale = attrs.get("scale", None)
        if scale is not None and scale != 1.0:
            out = out * scale
        return {"Out": [out]}

    return lower


for _name, _fn in (("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div),
                   ("elementwise_max", torch.maximum),
                   ("elementwise_min", torch.minimum),
                   ("elementwise_pow", torch.pow)):
    register(_name)(_elementwise(_fn))


def _compare(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [fn(x, bcast_y(x, y, attrs.get("axis", -1)))]}

    return lower


# comparisons: a bool Out, no gradient to either input
for _name, _fn in (("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("equal", torch.eq), ("not_equal", torch.ne)):
    register(_name, no_grad_inputs=("X", "Y"))(_compare(_fn))


@register("scale", handles_selected_rows=True)
def _scale(ctx, ins, attrs):
    """x * scale + bias (or (x + bias) * scale).  A SelectedRows X stays
    sparse under a bias of 0; a bias densifies it."""
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if isinstance(x, SelectedRows):
        if not b:
            return {"Out": [x.scaled(s)]}
        x = x.densify()
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register("clip")
def _clip(ctx, ins, attrs):
    """max then min against tensor bounds: their derivatives split a tie
    0.5 / 0.5 at a bound, as the reference's jnp.clip does
    (torch.clamp's gives 1 there)."""
    x = ins["X"][0]
    lo = torch.full((), attrs["min"], dtype=x.dtype, device=x.device)
    hi = torch.full((), attrs["max"], dtype=x.dtype, device=x.device)
    return {"Out": [torch.minimum(torch.maximum(x, lo), hi)]}


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    """X scaled to L2 norm max_norm where its norm is larger."""
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [torch.where(norm > max_norm, x * (max_norm / norm), x)]}


@register("sum", handles_selected_rows=True)
def _sum(ctx, ins, attrs):
    """The inputs' sum.  Over SelectedRows inputs alone the rows are
    concatenated (a sparse gradient's fan-in stays sparse; consumers
    merge or scatter-add duplicates); a mix with a dense input densifies
    (regularization on a sparse gradient)."""
    xs = ins["X"]
    if xs and all(isinstance(x, SelectedRows) for x in xs):
        return {"Out": [SelectedRows(torch.cat([x.rows for x in xs]),
                                     torch.cat([x.value for x in xs]),
                                     xs[0].height)]}
    xs = [densify_maybe(x) for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


def _reduce(fn):
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x)
            if keep:
                out = out.reshape((1,) * x.dim())
            return {"Out": [out]}
        dim = attrs.get("dim", [0])
        dims = tuple(d % x.dim() for d in (
            dim if isinstance(dim, (list, tuple)) else [dim]))
        return {"Out": [fn(x, dim=dims, keepdim=keep)]}

    return lower


register("reduce_sum")(_reduce(torch.sum))
register("reduce_mean")(_reduce(torch.mean))


@register("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [ins["X"][0].mean().reshape(1)]}


@register("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


def _take_label(x, label):
    """x[..., label] along the last axis; label [..., 1] or [...] int."""
    lbl = label.long()
    if lbl.dim() == x.dim():
        lbl = lbl[..., 0]
    return torch.gather(x, -1, lbl[..., None])


@register("label_smooth", no_grad_inputs=("PriorDist",))
def _label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    prior = ins.get("PriorDist", [None])[0]
    if prior is None:
        prior = 1.0 / x.shape[-1]
    return {"Out": [(1 - eps) * x + eps * prior]}


def softmax_xent_kernel_form(attrs, logits_dim):
    """Whether softmax_with_cross_entropy runs on fused_softmax_xent:
    hard labels, no ignore_index, 2-D logits (the reference's dispatch)."""
    return (not attrs.get("soft_label", False)
            and attrs.get("ignore_index", -100) < 0 and logits_dim == 2)


@register("softmax_with_cross_entropy", no_grad_inputs=("Label",))
def _softmax_xent(ctx, ins, attrs):
    """The kernel form (BERT's NSP head) goes to fused_softmax_xent, as
    in the reference: its kernels on CUDA tensors, Softmax computed
    beside them.  Every other form is the reference's dense one; the WMT
    builder's soft-label form and the LM heads' 3-D form are folded into
    fused_linear_xent by the fuse passes before the program runs."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    if softmax_xent_kernel_form(attrs, logits.dim()):
        loss = fused_softmax_xent(logits.contiguous(),
                                  label.reshape(-1).long().contiguous())
        return {"Softmax": [torch.softmax(logits, dim=-1)],
                "Loss": [loss.to(logits.dtype)]}
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(-1, keepdim=True)
    else:
        lp = _take_label(logp, label)
        ig = attrs.get("ignore_index", -100)
        if ig >= 0:
            lbl = label if label.dim() == logits.dim() else label[..., None]
            lp = lp * (lbl.long() != ig).to(logp.dtype)
        loss = -lp
    return {"Softmax": [logp.exp()], "Loss": [loss]}


@register("smooth_label_xent", no_grad_inputs=("Label",))
def _smooth_label_xent(ctx, ins, attrs):
    """Label-smoothed softmax cross-entropy in closed form (the target of
    smooth_label_xent_fuse_pass): with s = (1-eps) onehot(y) + eps/V,
    -sum(s logp) = (1-eps)(lse - z[y]) + eps (lse - mean(z)).  A label
    outside [0, V) (one_hot's all-zero row) gives the smoothing term
    only."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    eps = float(attrs.get("epsilon", 0.0))
    lg = logits.float()
    v = lg.shape[-1]
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    lbl = label.long()
    if lbl.dim() == lg.dim():
        lbl = lbl[..., 0]
    valid = ((lbl >= 0) & (lbl < v))[..., None]
    ly = torch.gather(lg, -1, lbl.clamp(0, v - 1)[..., None])
    smooth = (eps * (lse - lg.mean(-1, keepdim=True)) if eps
              else torch.zeros_like(lse))
    loss = torch.where(valid, (1.0 - eps) * (lse - ly),
                       torch.zeros_like(lse)) + smooth
    return {"Loss": [loss.to(logits.dtype)]}


@register("fused_linear_xent", no_grad_inputs=("Label",))
def _fused_linear_xent(ctx, ins, attrs):
    """Logits-free projected cross entropy (the target of
    linear_xent_fuse_pass): X [..., H], W [H, V] (or [V, H] with
    transpose_w), Label [..., 1] int.  On CUDA tensors the [R, V] logits
    never exist in device memory: the forward kernel streams vocab
    tiles through an online logsumexp and the backward kernels
    recompute each tile's softmax from the saved lse.

    transpose_w (the tied-embedding x @ W^T form) passes a contiguous
    [H, V] copy of W, as the reference does: the kernels read [H, V]
    tiles.  The copy is weights-sized, far below the [R, V] logits the
    fusion removes; a [V, H]-layout kernel would remove it (a documented
    limit of the reference too).

    Under a live mesh whose rule table vocab-shards W, the rank runs
    ``sharded_linear_xent`` on its slab (``spmd_epilogue``)."""
    x, w, label = ins["X"][0], ins["W"][0], ins["Label"][0]
    eps = float(attrs.get("epsilon", 0.0))
    transpose_w = bool(attrs.get("transpose_w", False))
    if transpose_w:
        w = w.t()
    h = x.shape[-1]
    x2, w = x.reshape(-1, h).contiguous(), w.contiguous()
    lbl = label.reshape(-1).long().contiguous()
    loss = spmd_linear_xent(ctx, x2, w, lbl, eps, transpose_w)
    if loss is None:
        loss = fused_linear_xent(x2, w, lbl, eps)
    return {"Loss": [loss.reshape(tuple(x.shape[:-1]) + (1,)).to(x.dtype)]}


@register("cross_entropy", no_grad_inputs=("Label",))
def _cross_entropy(ctx, ins, attrs):
    """-log of the probability X gives the label (hard), or -sum(label
    log X) (soft), X clipped below at 1e-20 first.  The clip is
    torch.maximum against a tensor bound, whose derivative splits a tie
    0.5 / 0.5 as the reference's jnp.clip does."""
    x, label = ins["X"][0], ins["Label"][0]
    floor = torch.full((), 1e-20, dtype=x.dtype, device=x.device)
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(torch.maximum(x, floor))).sum(
            -1, keepdim=True)
    else:
        loss = -torch.log(torch.maximum(_take_label(x, label), floor))
    return {"Y": [loss]}


@register("top_k", no_grad_inputs=("X",))
def _top_k(ctx, ins, attrs):
    vals, idx = torch.topk(ins["X"][0], int(attrs["k"]))
    return {"Out": [vals], "Indices": [idx]}


@register("accuracy", no_grad_inputs=("Out", "Indices", "Label"))
def _accuracy(ctx, ins, attrs):
    """The share of rows whose label is among their top-k indices, with
    the count of such rows and of all rows."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() < idx.dim():
        label = label[..., None]
    correct = (idx == label.to(idx.dtype)).any(-1)
    total = correct.shape[0]
    num_correct = correct.to(torch.int64).sum()
    return {"Accuracy": [(num_correct.float() / total).reshape(1)],
            "Correct": [num_correct.reshape(1)],
            "Total": [torch.full((1,), total, dtype=torch.int64,
                                 device=idx.device)]}


@register("log")
def _log(ctx, ins, attrs):
    return {"Out": [torch.log(ins["X"][0])]}


@register("sqrt")
def _sqrt(ctx, ins, attrs):
    return {"Out": [torch.sqrt(ins["X"][0])]}


@register("square")
def _square(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0])]}


@register("sign")
def _sign(ctx, ins, attrs):
    return {"Out": [torch.sign(ins["X"][0])]}


@register("pow")
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


@register("relu")
def _relu(ctx, ins, attrs):
    """torch.maximum against zero: its derivative is 0.5 at x == 0, as
    the reference's jnp.maximum's (torch.relu's is 0)."""
    x = ins["X"][0]
    return {"Out": [torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))]}


@register("sigmoid")
def _sigmoid(ctx, ins, attrs):
    """fc(act="sigmoid") emits it (SE-ResNeXt's excitation)."""
    return {"Out": [torch.sigmoid(ins["X"][0])]}


@register("tanh")
def _tanh(ctx, ins, attrs):
    """fc(act="tanh") emits it (BERT's pooler, before fc_fuse_pass folds
    it into the fc op)."""
    return {"Out": [torch.tanh(ins["X"][0])]}


@register("gelu")
def _gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(ins["X"][0],
                                             approximate=approximate)]}


@register("swish")
def _swish(ctx, ins, attrs):
    """x sigmoid(beta x): fc(act="swish") emits it (the SwiGLU gate
    before swiglu_fuse_pass folds it into fused_swiglu)."""
    x = ins["X"][0]
    return {"Out": [x * torch.sigmoid(attrs.get("beta", 1.0) * x)]}


def _clip(x, lo, hi):
    """jnp.clip's order: maximum, then minimum, against scalar tensors,
    whose derivative splits a tie 0.5 / 0.5 as jnp's does."""
    def scalar(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, scalar(lo)), scalar(hi))


def _act(fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], attrs)]}

    return lower


# the rest of the reference's activation table (its _ACTS, with selu from
# its image ops), each with the reference's attrs and their defaults; the
# grads come from the generic vjp of these forward rules
_ACTS = {
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "abs": lambda x, a: torch.abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),
    "cos": lambda x, a: torch.cos(x),
    "sin": lambda x, a: torch.sin(x),
    "exp": lambda x, a: torch.exp(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "relu6": lambda x, a: _clip(x, 0.0, a.get("threshold", 6.0)),
    "leaky_relu": lambda x, a: torch.where(x > 0, x,
                                           a.get("alpha", 0.02) * x),
    "elu": lambda x, a: torch.where(
        x > 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1)),
    "hard_sigmoid": lambda x, a: _clip(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "brelu": lambda x, a: _clip(x, a.get("t_min", 0.0), a.get("t_max", 24.0)),
    "soft_relu": lambda x, a: torch.log(1 + torch.exp(_clip(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 0.67) * x),
    "thresholded_relu": lambda x, a: torch.where(
        x > a.get("threshold", 1.0), x, torch.zeros_like(x)),
    "hard_shrink": lambda x, a: torch.where(
        torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "logsigmoid": lambda x, a: torch.nn.functional.logsigmoid(x),
    "erf": lambda x, a: torch.erf(x),
    "selu": lambda x, a: a.get("scale", 1.0507009873554804934193349852946)
    * torch.where(x > 0, x, a.get("alpha", 1.6732632423543772848170429916717)
                  * (torch.exp(x) - 1.0)),
}
for _name, _fn in _ACTS.items():
    register(_name)(_act(_fn))


def _flatten2(x, ncol):
    lead = 1
    for d in x.shape[:ncol]:
        lead *= d
    return x.reshape(lead, -1)


@register("mul")
def _mul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    out = _flatten2(x, xn) @ _flatten2(y, yn)
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


@register("matmul")
def _matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    tx, ty = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    if x.dim() == 1:
        x = x[None, :] if not tx else x[:, None]
    if y.dim() == 1:
        y = y[:, None] if not ty else y[None, :]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}
