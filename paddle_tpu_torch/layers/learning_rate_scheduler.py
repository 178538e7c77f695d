"""Learning-rate schedules (the counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``): in-graph ops over a
persistable step counter that an ``increment`` op advances each run.
Every op a schedule appends carries the ``lrsched`` op role, as in the
reference, and each schedule appends the reference's ops in its order:
``noam_decay`` (the Transformer's), ``exponential_decay``,
``natural_exp_decay``, ``inverse_time_decay``, ``polynomial_decay``,
``piecewise_decay``, ``cosine_decay``, ``linear_lr_warmup`` and
``append_LARS``."""

import functools
import math

from .. import framework
from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn, ops, tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "linear_lr_warmup", "append_LARS"]


def _lrsched(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prog = framework.default_main_program()
        with prog._op_role_guard("lrsched"):
            return fn(*args, **kwargs)

    return wrapper


def _decay_step_counter(begin=0):
    helper = LayerHelper("global_step_counter")
    counter = helper.create_or_get_global_variable(
        name="@LR_DECAY_COUNTER@", dtype="float32", shape=[1],
        persistable=True)
    if not getattr(counter, "_initialized", False):
        helper.set_variable_initializer(counter, Constant(float(begin)))
        counter._initialized = True
        helper.append_op("increment", inputs={"X": [counter]},
                         outputs={"Out": [counter]}, attrs={"step": 1.0})
        counter.stop_gradient = True
    return counter


@_lrsched
def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 min(step^-0.5, step warmup^-1.5), step from 1."""
    step = _decay_step_counter(1)
    a = step ** -0.5
    b = (warmup_steps ** -1.5) * step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


@_lrsched
def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr decay_rate^(step / decay_steps), the exponent floored with
    `staircase`."""
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return learning_rate * (decay_rate ** div)


@_lrsched
def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr exp(-decay_rate step / decay_steps)."""
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return learning_rate * ops.exp(-1 * decay_rate * div)


@_lrsched
def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate step / decay_steps)."""
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return learning_rate / (1 + decay_rate * div)


@_lrsched
def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) (1 - step / decay_steps)^power + end, the fraction
    capped at 1, or with `cycle` over decay_steps rounded up to a
    multiple that covers the step."""
    step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(step / float(decay_steps))
        decay_steps_var = float(decay_steps) * div_res
        frac = step / decay_steps_var
    else:
        frac = nn.elementwise_min(step / float(decay_steps),
                                  tensor.fill_constant([1], "float32", 1.0))
    return ((learning_rate - end_learning_rate) * ((1 - frac) ** power)
            + end_learning_rate)


def _step_lt(step, bound):
    """1.0 while step < bound, else 0.0, in float32 (a less_than cast):
    branch-free, as the reference's."""
    b = tensor.fill_constant([1], "float32", float(bound))
    helper = LayerHelper("less_than")
    cond = helper.create_variable_for_type_inference("bool")
    helper.append_op("less_than", inputs={"X": [step], "Y": [b]},
                     outputs={"Out": [cond]}, attrs={})
    return tensor.cast(cond, "float32")


@_lrsched
def piecewise_decay(boundaries, values):
    """values[i] for step in [boundaries[i - 1], boundaries[i]), as a sum
    of exact interval masks."""
    assert len(boundaries) + 1 == len(values)
    step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", 0.0)
    for i, v in enumerate(values):
        if i == 0:
            m = _step_lt(step, boundaries[0])
        elif i < len(boundaries):
            m = _step_lt(step, boundaries[i]) - _step_lt(step,
                                                         boundaries[i - 1])
        else:
            m = 1.0 - _step_lt(step, boundaries[-1])
        lr = lr + m * v
    return lr


@_lrsched
def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr (cos(pi floor(step / step_each_epoch) / epochs) + 1) / 2."""
    step = _decay_step_counter()
    epoch = ops.floor(step / step_each_epoch)
    return 0.5 * learning_rate * (ops.cos(epoch * (math.pi / epochs)) + 1)


@_lrsched
def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr + (end_lr - start_lr) step / warmup_steps while step <
    warmup_steps, then `learning_rate` (a float or a schedule's var)."""
    step = _decay_step_counter()
    linear = start_lr + (end_lr - start_lr) * (step / float(warmup_steps))
    m = _step_lt(step, warmup_steps)
    if isinstance(learning_rate, float):
        learning_rate = tensor.fill_constant([1], "float32", learning_rate)
    return m * linear + (1.0 - m) * learning_rate


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rate scaling: per parameter

        lr_p = lr |param| / (|grad| + weight_decay |param|),

    written into ``param.optimize_attr["learning_rate"]`` as a var, which
    the optimizer's per-parameter rate reads.  Returns the rates."""
    out = []
    for param, grad in params_grads:
        if grad is None:
            continue
        prog = param.block.program
        with prog._optimized_guard([param, grad]):
            param_lr = (param.optimize_attr or {}).get("learning_rate", 1.0)
            param_norm = ops.sqrt(nn.reduce_sum(ops.square(param)))
            grad_norm = ops.sqrt(nn.reduce_sum(ops.square(grad)))
            base = (learning_rate
                    if isinstance(param_lr, float) and param_lr == 1.0
                    else learning_rate * param_lr)
            decayed_lr = base * param_norm / (
                grad_norm + weight_decay * param_norm)
            param.optimize_attr["learning_rate"] = decayed_lr
            out.append(decayed_lr)
    return out
