"""In-graph metric layers (the counterpart of
``paddle_tpu/layers/metric_op.py``), limited to ``accuracy``."""

from ..layer_helper import LayerHelper
from . import nn

__all__ = ["accuracy"]


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
