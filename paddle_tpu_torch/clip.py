"""Gradient clipping (the counterpart of ``paddle_tpu/clip.py``): by
value, by norm and by global norm, emitted as ops on the gradients.
Global-norm clips are grouped by ``group_name``, so the norm spans the
whole group; its ``square`` densifies a SelectedRows gradient, as the
reference's does."""

from . import framework, layers

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]

_clip_attr = None


class BaseGradientClipAttr:
    def _process(self, param, grad):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, param, grad):
        return param, layers.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, param, grad):
        return param, layers.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_group(self, params_grads):
        """Each grad scaled by clip_norm / max(global norm, clip_norm)."""
        sq = [layers.reduce_sum(layers.square(g))
              for _, g in params_grads if g is not None]
        global_norm = layers.sqrt(layers.sums(sq))
        clip_val = layers.fill_constant([1], "float32", self.clip_norm)
        scale = clip_val / layers.elementwise_max(global_norm, clip_val)
        return [(p, g if g is None else layers.elementwise_mul(g, scale))
                for p, g in params_grads]


def set_gradient_clip(clip, param_list=None, program=None):
    """`clip` for the listed parameters (names or Parameters), or, with
    no list, for every parameter without its own."""
    global _clip_attr
    if param_list is None:
        _clip_attr = clip
        return
    program = program or framework.default_main_program()
    for p in param_list:
        if isinstance(p, str):
            p = program.global_block().var(p)
        p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    if _clip_attr is None and not any(
            p.gradient_clip_attr is not None for p, _ in params_grads):
        return params_grads
    out, groups = [], {}
    for p, g in params_grads:
        clip = p.gradient_clip_attr or _clip_attr
        if g is None or clip is None:
            out.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            groups.setdefault(clip.group_name, (clip, []))[1].append((p, g))
        else:
            out.append(clip._process(p, g))
    for clip, pgs in groups.values():
        out.extend(clip._process_group(pgs))
    return out
