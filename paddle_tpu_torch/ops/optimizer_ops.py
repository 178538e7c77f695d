"""Optimizer op lowerings (the counterpart of
``paddle_tpu/ops/optimizer_ops.py``): ``sgd``, ``momentum`` and
``adam``, the dense forms (the SelectedRows branches wait for ROADMAP
A1).  Each op maps (param, grad, accumulators) to the updated tensors
under the ``*Out`` slots, which name the same vars, so the executor
writes them back into the scope.  None is differentiated: optimizer ops
sit after the backward.
"""

import torch

from ..core.registry import register


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register("sgd", no_grad_inputs=("Param", "Grad", "LearningRate"))
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [p - _lr(ins) * g.to(p.dtype)]}


@register("momentum", no_grad_inputs=("Param", "Grad", "Velocity",
                                      "LearningRate"))
def _momentum(ctx, ins, attrs):
    """v = mu v + g; p -= lr v, or with use_nesterov p -= (g + mu v) lr."""
    p, v = ins["Param"][0], ins["Velocity"][0]
    g = ins["Grad"][0].to(p.dtype)
    mu = attrs.get("mu", 0.9)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * _lr(ins)
    else:
        p_out = p - _lr(ins) * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register("adam", no_grad_inputs=("Param", "Grad", "Moment1", "Moment2",
                                  "Beta1Pow", "Beta2Pow", "LearningRate"))
def _adam(ctx, ins, attrs):
    """Adam with bias correction folded into the step size, as the
    reference: lr_t = lr sqrt(1 - beta2^t) / (1 - beta1^t)."""
    p, g = ins["Param"][0], ins["Grad"][0].to(ins["Param"][0].dtype)
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * torch.square(g)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out], "Beta1PowOut": [b1p * beta1],
            "Beta2PowOut": [b2p * beta2]}
