"""Weight-decay regularizers (the counterpart of
``paddle_tpu/regularizer.py``): ops appended onto each gradient before
the optimizer ops.  L2 adds coeff * param, L1 coeff * sign(param),
through a ``sum`` op: on a SelectedRows gradient that sum densifies, as
the reference's does."""

from . import unique_name

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


def _like(block, param, suffix):
    return block.create_var(
        name=unique_name.generate(param.name + suffix), shape=param.shape,
        dtype=param.dtype, stop_gradient=True)


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = _like(block, param, "_l2decay")
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = _like(block, param, "_sign")
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = _like(block, param, "_l1decay")
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """[(param, grad)] with each regularized grad replaced by grad + the
    decay term: the parameter's own regularizer (``ParamAttr``) first,
    else `regularization` (the optimizer's)."""
    from .framework import default_main_program

    block = default_main_program().global_block()
    out = []
    for param, grad in parameters_and_grads:
        reg = (param.regularizer or regularization) if grad is not None \
            else None
        if reg is None:
            out.append((param, grad))
            continue
        term = reg(param, grad, block)
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + "_reg"), shape=grad.shape,
            dtype=grad.dtype, stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, term]},
                        outputs={"Out": [new_grad]})
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
