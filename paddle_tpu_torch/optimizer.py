"""Optimizers (the counterpart of ``paddle_tpu/optimizer.py``).

``Optimizer.minimize`` = ``append_backward`` + one optimizer op per
parameter, with the accumulators (Momentum's velocities, Adam's moments
and beta powers) as persistable vars initialized by the startup
program.  The ops update their state in place (``ParamOut`` names the
param), as the reference's do; the executor writes the updated
persistables back into the scope.  Gradient clipping and regularization are not ported yet
(ROADMAP A1): asking for them raises.
"""

from . import framework, unique_name
from .backward import append_backward
from .framework import Variable
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["SGD", "Momentum", "Adam", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if regularization is not None:
            raise NotImplementedError("regularization is not ported yet "
                                      "(ROADMAP A1)")
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = {}  # name -> {param_name: var}
        self.helper = None
        self.type = self.__class__.__name__.lower()

    def _create_global_learning_rate(self):
        program = framework.default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        from .layers import tensor

        self._learning_rate_map[program] = tensor.create_global_var(
            name=unique_name.generate("learning_rate"), shape=[1],
            value=float(self._learning_rate), dtype="float32",
            persistable=True)

    def _global_learning_rate(self, program=None):
        if program is None:
            program = framework.default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param_lr = (param_and_grad[0].optimize_attr or {}).get(
            "learning_rate", 1.0)
        if isinstance(param_lr, Variable):
            return param_lr
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        from .layers import nn

        return nn.scale(base, scale=float(param_lr))

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        block = framework.default_main_program().global_block()
        shape = list(shape or param.shape)
        var = block.create_var(
            name=unique_name.generate(param.name + "_" + name), shape=shape,
            dtype=dtype or param.dtype, persistable=True, stop_gradient=True)
        sb = framework.default_startup_program().global_block()
        sv = sb.create_var(name=var.name, shape=shape, dtype=var.dtype,
                           persistable=True)
        Constant(float(fill_value))(sv, sb)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _create_optimization_pass(self, parameters_and_grads):
        program = framework.default_main_program()
        block = program.global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None or not param_and_grad[0].trainable:
                continue
            with program._optimized_guard(list(param_and_grad)):
                optimize_ops.append(
                    self._append_optimize_op(block, param_and_grad))
        return optimize_ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        if any(getattr(p, "gradient_clip_attr", None)
               for p, _ in params_grads):
            raise NotImplementedError("gradient clipping is not ported yet "
                                      "(ROADMAP A1)")
        return self._create_optimization_pass(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            "momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            "adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
