"""Optimizers (the counterpart of ``paddle_tpu/optimizer.py``).

``Optimizer.minimize`` = ``append_backward`` + gradient clipping
(``clip.py``) + regularization (``regularizer.py``) + one optimizer op
per parameter, with the accumulators (velocities, moments, beta powers)
as persistable vars initialized by the startup program, under the
reference's names, so a state saved by either package carries over.
The ops update their state in place (``ParamOut`` names the param), as
the reference's do; the executor writes the updated persistables back
into the scope.  ``ModelAverage`` keeps a windowed sum of every
trainable parameter and swaps the average in around an evaluation;
``GradientMergeOptimizer`` accumulates k steps' gradients in one program
and applies them in a second.
"""

import contextlib

from . import framework, unique_name
from .backward import append_backward
from .framework import Variable
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["SGD", "Momentum", "LarsMomentum", "Adagrad", "Adam", "Adamax",
           "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl", "ModelAverage",
           "GradientMergeOptimizer", "SGDOptimizer", "MomentumOptimizer",
           "LarsMomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
           "AdamaxOptimizer", "DecayedAdagradOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
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

    def _finish_update(self, block, parameters_and_grads):
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
        self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        from . import clip, regularizer

        params_grads = clip.append_gradient_clip_ops(params_grads)
        params_grads = regularizer.append_regularization_ops(
            params_grads, self.regularization)
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


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            "adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        inf_norm = self._get_accumulator("inf_norm", param)
        return block.append_op(
            "adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "InfNorm": [inf_norm],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc",
                                                       param)],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, parameters_and_grads):
        """beta1^t advances by a scale op a parameter, after every
        update."""
        for param, grad in parameters_and_grads:
            if grad is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", param)
            block.append_op("scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("_avg_squared_grad", p)
            self._add_accumulator("_avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        asg = self._get_accumulator("_avg_squared_grad", param)
        asu = self._get_accumulator("_avg_squared_update", param)
        return block.append_op(
            "adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        mom = self._get_accumulator("momentum", param)
        ms = self._get_accumulator("mean_square", param)
        mg = self._get_accumulator("mean_grad", param)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [param], "Grad": [grad], "Moment": [mom],
                    "MeanSquare": [ms], "MeanGrad": [mg],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return block.append_op(
            "ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer


class ModelAverage(Optimizer):
    """Parameter averaging for evaluation.  Built after minimize, it
    appends one ``model_average_accum`` op a trainable parameter: a
    running sum over a window that restarts once it exceeds
    min(max_average_window, max(min_average_window, average_window_rate
    * updates)).  ``apply(exe)`` is a context manager that puts each
    parameter's windowed average in the scope, and the trained values
    back after; ``restore`` is a no-op kept for the reference's API.

        opt.minimize(loss)
        model_average = ModelAverage(0.15)
        ...train...
        with model_average.apply(exe):
            ...evaluate with the averaged weights...
    """

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._accums = {}  # param name -> (sum var, num var)
        main = framework.default_main_program()
        block = main.global_block()
        with main._op_role_guard("optimize"):
            for param in block.all_parameters():
                if not param.trainable:
                    continue
                helper = LayerHelper("model_average")

                def acc(suffix, dtype, shape):
                    return helper.create_global_variable(
                        name=unique_name.generate(param.name + suffix),
                        persistable=True, dtype=dtype, shape=shape)

                psum = acc("_avg_sum", param.dtype, param.shape)
                num = acc("_avg_num", "float32", [1])
                num_upd = acc("_avg_nupd", "float32", [1])
                for v in (psum, num, num_upd):
                    helper.set_variable_initializer(v, Constant(0.0))
                block.append_op(
                    "model_average_accum",
                    inputs={"Param": [param], "Sum": [psum], "Num": [num],
                            "NumUpdates": [num_upd]},
                    outputs={"SumOut": [psum], "NumOut": [num],
                             "NumUpdatesOut": [num_upd]},
                    attrs={"average_window_rate": float(average_window_rate),
                           "min_average_window": int(min_average_window),
                           "max_average_window": int(max_average_window)})
                self._accums[param.name] = (psum, num)

    def apply(self, executor, need_restore=True):
        """Context manager: each parameter := sum / num inside (where num
        > 0), its trained value back after (with need_restore)."""
        from .core.scope import global_scope

        @contextlib.contextmanager
        def ctx():
            scope = global_scope()
            backup = {}
            for pname, (psum, num) in self._accums.items():
                # a copy: a run inside writes the average into the
                # tensor the executor holds for the parameter
                backup[pname] = scope.get(pname).clone()
                n = float(scope.get(num.name).reshape(-1)[0])
                if n > 0:
                    scope.set(pname, (scope.get(psum.name) / n).to(
                        backup[pname].dtype))
            try:
                yield
            finally:
                if need_restore:
                    for pname, val in backup.items():
                        scope.set(pname, val)

        return ctx()

    def restore(self, executor):
        """A no-op: apply() restores on exit (the reference's API)."""


class GradientMergeOptimizer:
    """Gradient accumulation over k micro-batches in two programs with
    static shapes, as the reference's: the main program adds each step's
    gradients into persistable buffers (``<param>@GRAD@MERGED``) and
    updates no weight; ``apply_program`` (returned by minimize) runs the
    inner optimizer on the buffers (averaged with `avg`) and zeroes
    them.  Run it every k-th step:

        opt = GradientMergeOptimizer(Adam(1e-3), k_steps=4)
        apply_prog = opt.minimize(loss)
        for i, batch in enumerate(batches):
            exe.run(feed=batch, fetch_list=[loss])
            if (i + 1) % 4 == 0:
                exe.run(apply_prog)

    Clipping and regularization on the inner optimizer apply to the
    merged gradient, once per merged batch."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        self.inner = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = bool(avg)
        self.apply_program = None

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import nn

        main = framework.default_main_program()
        startup = startup_program or framework.default_startup_program()
        block = main.global_block()
        params_grads = self.inner.backward(loss, startup, parameter_list,
                                           no_grad_set)
        merged = []  # (param, buffer)
        with main._op_role_guard("optimize"):
            for param, grad in params_grads:
                if grad is None or not param.trainable:
                    continue
                acc = block.create_var(
                    name=param.name + "@GRAD@MERGED", shape=list(param.shape),
                    dtype=param.dtype, persistable=True, stop_gradient=True)
                sb = startup.global_block()
                sv = sb.create_var(name=acc.name, shape=list(param.shape),
                                   dtype=param.dtype, persistable=True)
                Constant(0.0)(sv, sb)
                block.append_op("elementwise_add",
                                inputs={"X": [acc.name], "Y": [grad.name]},
                                outputs={"Out": [acc.name]},
                                attrs={"axis": -1})
                merged.append((param, acc))

        # the apply program shares the scope with main by name
        apply_prog = framework.Program()
        with framework.program_guard(apply_prog, startup):
            ablock = apply_prog.global_block()
            pg = []
            for param, acc in merged:
                p2 = framework.Parameter(ablock, list(param.shape),
                                         param.dtype, name=param.name)
                p2.trainable = True
                p2.optimize_attr = param.optimize_attr
                p2.regularizer = param.regularizer
                p2.gradient_clip_attr = param.gradient_clip_attr
                ablock.vars[param.name] = p2
                a2 = ablock.create_var(
                    name=acc.name, shape=list(param.shape), dtype=param.dtype,
                    persistable=True, stop_gradient=True)
                g = (nn.scale(a2, scale=1.0 / self.k_steps)
                     if self.avg and self.k_steps > 1 else a2)
                pg.append((p2, g))
            self.inner.apply_gradients(pg)
            with apply_prog._op_role_guard("optimize"):
                for param, acc in merged:
                    ablock.append_op(
                        "fill_constant", inputs={}, outputs={"Out": [acc.name]},
                        attrs={"shape": list(acc.shape), "dtype": param.dtype,
                               "value": 0.0})
        self.apply_program = apply_prog
        return apply_prog
