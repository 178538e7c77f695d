"""In-graph metric layers (the counterpart of
``paddle_tpu/layers/metric_op.py``): ``accuracy`` and ``auc``."""

from ..layer_helper import LayerHelper
from . import nn

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the top-k of `input`."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = nn.topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference("int64")
    if total is None:
        total = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    acc_out.stop_gradient = True
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=2 ** 12 - 1, topk=1,
        slide_steps=1):
    """Streaming in-graph AUC: two auc ops over the same batch, a global
    accumulator (slide_steps 0) and a batch one over the last
    `slide_steps` batches (0: over every batch, so it equals the global
    one).  Returns (auc_out, batch_auc_out, [batch_stat_pos,
    batch_stat_neg, stat_pos, stat_neg]), as the reference.  `topk` is
    accepted for the signature and unused, as there."""
    from .. import unique_name
    from ..initializer import Constant

    slide_steps = max(0, int(slide_steps))
    helper = LayerHelper("auc")

    def _stat(name, shape):
        v = helper.create_global_variable(
            persistable=True, name=unique_name.generate(name), shape=shape,
            dtype="float32")
        helper.set_variable_initializer(v, Constant(0.0))
        return v

    nb = num_thresholds + 1
    batch_stat_pos = _stat("auc_batch_stat_pos", [max(1, slide_steps), nb])
    batch_stat_neg = _stat("auc_batch_stat_neg", [max(1, slide_steps), nb])
    stat_pos = _stat("auc_stat_pos", [1, nb])
    stat_neg = _stat("auc_stat_neg", [1, nb])

    def _auc_op(sp, sn, steps):
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            "auc",
            inputs={"Predict": [input], "Label": [label], "StatPos": [sp],
                    "StatNeg": [sn]},
            outputs={"AUC": [out], "StatPosOut": [sp], "StatNegOut": [sn]},
            attrs={"num_thresholds": num_thresholds, "curve": curve,
                   "slide_steps": steps})
        out.stop_gradient = True
        return out

    batch_auc_out = _auc_op(batch_stat_pos, batch_stat_neg, slide_steps)
    auc_out = _auc_op(stat_pos, stat_neg, 0)
    return auc_out, batch_auc_out, [batch_stat_pos, batch_stat_neg,
                                    stat_pos, stat_neg]
