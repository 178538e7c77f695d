"""Optimizer op lowerings (the counterpart of
``paddle_tpu/ops/optimizer_ops.py``).  Each op maps (param, grad,
accumulators) to the updated tensors under the ``*Out`` slots, which
name the same vars, so the executor writes them back into the scope.
None is differentiated: optimizer ops sit after the backward.

``sgd``, ``momentum``, ``adam`` and ``adagrad`` take a SelectedRows
gradient as it is (``core/selected_rows.py``): ``sgd`` adds the rows
without merging them, ``momentum`` densifies the merged rows and decays
every row, ``adam`` (lazy) and ``adagrad`` merge the rows and update
only those rows of the parameter and the moments.  Those three update
their tensors in place, so a sparse step holds no table-sized temporary;
the executor finds its own tensors among the outputs and writes nothing
back.  The other optimizers get the gradient densified.
"""

import torch

from ..core.registry import register
from ..core.selected_rows import SelectedRows, slots, spread


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register("sgd", no_grad_inputs=("Param", "Grad", "LearningRate"),
          handles_selected_rows=True)
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    if isinstance(g, SelectedRows):
        # each row added as it comes: duplicates sum linearly, no merge
        upd = -_lr(ins) * g.value.to(p.dtype)
        upd = torch.where((g.rows < g.height)[:, None], upd,
                          torch.zeros_like(upd))
        return {"ParamOut": [p.index_put_((spread(g.rows, g.height),), upd,
                                          accumulate=True)]}
    return {"ParamOut": [p - _lr(ins) * g.to(p.dtype)]}


@register("momentum", no_grad_inputs=("Param", "Grad", "Velocity",
                                      "LearningRate"),
          handles_selected_rows=True)
def _momentum(ctx, ins, attrs):
    """v = mu v + g; p -= lr v, or with use_nesterov p -= (g + mu v) lr.
    A SelectedRows gradient is merged and densified (zero elsewhere), so
    every row's velocity decays, as the reference's sparse branch does."""
    p, v = ins["Param"][0], ins["Velocity"][0]
    g = ins["Grad"][0]
    g = (g.merged().densify() if isinstance(g, SelectedRows) else g).to(
        p.dtype)
    mu = attrs.get("mu", 0.9)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * _lr(ins)
    else:
        p_out = p - _lr(ins) * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register("lars_momentum", no_grad_inputs=("Param", "Grad", "Velocity",
                                           "LearningRate"))
def _lars_momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = _lr(ins) * coeff * p_norm / (g_norm + decay * p_norm + 1e-15)
    v_out = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register("adam", no_grad_inputs=("Param", "Grad", "Moment1", "Moment2",
                                  "Beta1Pow", "Beta2Pow", "LearningRate"),
          handles_selected_rows=True)
def _adam(ctx, ins, attrs):
    """Adam with bias correction folded into the step size, as the
    reference: lr_t = lr sqrt(1 - beta2^t) / (1 - beta1^t).  A
    SelectedRows gradient takes the lazy branch: the merged rows' moments
    decay and update, and only those rows move; the beta powers advance
    all the same."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    pows = {"Beta1PowOut": [b1p * beta1], "Beta2PowOut": [b2p * beta2]}
    if isinstance(g, SelectedRows):
        rows, gv, valid, add_rows = slots(g.merged())
        gv = gv.to(p.dtype)
        m1n = beta1 * m1[rows] + (1 - beta1) * gv
        m2n = beta2 * m2[rows] + (1 - beta2) * torch.square(gv)
        upd = -lr_t * m1n / (torch.sqrt(m2n) + eps)
        return {"ParamOut": [p.index_put_((add_rows,), upd * valid,
                                          accumulate=True)],
                "Moment1Out": [m1.index_put_((rows,), m1n)],
                "Moment2Out": [m2.index_put_((rows,), m2n)], **pows}
    g = g.to(p.dtype)
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * torch.square(g)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out], **pows}


@register("adamax", no_grad_inputs=("Param", "Grad", "Moment", "InfNorm",
                                    "Beta1Pow", "LearningRate"))
def _adamax(ctx, ins, attrs):
    """Beta1Pow advances by the optimizer's own scale op, not here."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, u = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    beta1, beta2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = beta1 * m + (1 - beta1) * g
    u_out = torch.maximum(beta2 * u, torch.abs(g))
    p_out = p - (_lr(ins) / (1 - b1p.reshape(()))) * m_out / (u_out + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out], "InfNormOut": [u_out]}


@register("adagrad", no_grad_inputs=("Param", "Grad", "Moment",
                                     "LearningRate"),
          handles_selected_rows=True)
def _adagrad(ctx, ins, attrs):
    """m += g^2; p -= lr g / (sqrt(m) + eps).  A SelectedRows gradient
    is merged (the moment is not linear in g) and touches only its rows;
    an untouched row's dense update is exactly zero, so the two agree."""
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(ins)
    if isinstance(g, SelectedRows):
        rows, gv, valid, add_rows = slots(g.merged())
        gv = gv.to(p.dtype)
        m_new = m[rows] + torch.square(gv)
        upd = -lr * gv / (torch.sqrt(m_new) + eps)
        return {"ParamOut": [p.index_put_((add_rows,), upd * valid,
                                          accumulate=True)],
                "MomentOut": [m.index_put_((rows,), m_new)]}
    m_out = m + torch.square(g)
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_out) + eps)],
            "MomentOut": [m_out]}


def _prox(x, lr, l1, l2):
    """The proximal step: soft-threshold by lr l1, shrink by 1 / (1 +
    lr l2)."""
    if l1 > 0:
        x = torch.sign(x) * torch.clamp(torch.abs(x) - lr * l1, min=0.0)
    return x / (1.0 + lr * l2)


@register("proximal_gd", no_grad_inputs=("Param", "Grad", "LearningRate"))
def _proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    l1, l2 = float(attrs.get("l1", 0.0)), float(attrs.get("l2", 0.0))
    return {"ParamOut": [_prox(p - lr * g.to(p.dtype), lr, l1, l2)]}


@register("proximal_adagrad", no_grad_inputs=("Param", "Grad", "Moment",
                                              "LearningRate"))
def _proximal_adagrad(ctx, ins, attrs):
    """The adagrad step p - lr g / sqrt(m + g^2), then the proximal step
    with the plain lr, as the reference; g == 0 where m == 0 gives a 0
    step, not 0/0."""
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _lr(ins)
    l1, l2 = float(attrs.get("l1", 0.0)), float(attrs.get("l2", 0.0))
    m_out = m + torch.square(g)
    denom = torch.sqrt(m_out)
    upd = torch.where(denom > 0, g.to(p.dtype) / denom,
                      torch.zeros_like(denom))
    return {"ParamOut": [_prox(p - lr * upd, lr, l1, l2)],
            "MomentOut": [m_out]}


@register("decayed_adagrad", no_grad_inputs=("Param", "Grad", "Moment",
                                             "LearningRate"))
def _decayed_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_out) + eps)],
            "MomentOut": [m_out]}


@register("adadelta", no_grad_inputs=("Param", "Grad", "AvgSquaredGrad",
                                      "AvgSquaredUpdate"))
def _adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    asg, asu = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * asg + (1 - rho) * torch.square(g)
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    asu_out = rho * asu + (1 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register("rmsprop", no_grad_inputs=("Param", "Grad", "Moment", "MeanSquare",
                                     "MeanGrad", "LearningRate"))
def _rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    mom, ms = ins["Moment"][0], ins["MeanSquare"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_out = rho * ins["MeanGrad"][0] + (1 - rho) * g
        denom = ms_out - torch.square(mg_out) + eps
    else:
        mg_out = (ins["MeanGrad"][0] if ins.get("MeanGrad")
                  else torch.zeros_like(p))
        denom = ms_out + eps
    mom_out = momentum * mom + _lr(ins) * g / torch.sqrt(denom)
    return {"ParamOut": [p - mom_out], "MomentOut": [mom_out],
            "MeanSquareOut": [ms_out], "MeanGradOut": [mg_out]}


@register("ftrl", no_grad_inputs=("Param", "Grad", "SquaredAccumulator",
                                  "LinearAccumulator", "LearningRate"))
def _ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
        denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    new_lin = lin + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    return {"ParamOut": [pre / denom], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [new_lin]}


@register("model_average_accum", no_grad_inputs=("Param", "Sum", "Num",
                                                 "NumUpdates"))
def _model_average_accum(ctx, ins, attrs):
    """ModelAverage's running sum of a parameter, restarted once the
    window exceeds min(max_average_window, max(min_average_window,
    average_window_rate * updates)), as the reference's one op does."""
    p, s, n = ins["Param"][0], ins["Sum"][0], ins["Num"][0]
    nu = ins["NumUpdates"][0] if ins.get("NumUpdates") else n
    rate = float(attrs.get("average_window_rate", 0.15))
    min_w = float(attrs.get("min_average_window", 10000))
    max_w = float(attrs.get("max_average_window", 10000))
    new_nu = nu + 1.0
    threshold = torch.clamp(rate * new_nu, min_w, max_w)
    new_n = n + 1.0
    restart = new_n > threshold
    s_out = torch.where(restart, p.to(s.dtype), s + p.to(s.dtype))
    n_out = torch.where(restart, torch.ones_like(n), new_n)
    return {"SumOut": [s_out], "NumOut": [n_out], "NumUpdatesOut": [new_nu]}
