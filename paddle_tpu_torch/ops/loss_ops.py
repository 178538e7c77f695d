"""Loss op lowerings (the counterpart of ``paddle_tpu/ops/loss_ops.py``),
limited to ``log_loss``, DeepFM's loss."""

import torch

from ..core.registry import register


@register("log_loss")
def _log_loss(ctx, ins, attrs):
    """The negative log likelihood of a probability:
    -y log(p + eps) - (1 - y) log(1 - p + eps)."""
    p, y = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-y * torch.log(p + eps)
                     - (1.0 - y) * torch.log(1.0 - p + eps)]}
