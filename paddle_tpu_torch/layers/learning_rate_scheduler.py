"""Learning-rate schedules (the counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``): in-graph ops over a
persistable step counter that an ``increment`` op advances each run.
Every op a schedule appends carries the ``lrsched`` op role, as in the
reference.  Ported: ``noam_decay`` (the Transformer's schedule)."""

import functools

from .. import framework
from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn

__all__ = ["noam_decay"]


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
