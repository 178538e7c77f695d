"""In-graph metric op lowerings (the counterpart of
``paddle_tpu/ops/metric_ops.py``), limited to ``auc``.

The running statistics come in as inputs and go out under the ``*Out``
slots that name the same vars, so the executor writes them back into
the scope.
"""

import torch

from ..core.registry import register


@register("auc", no_grad_inputs=("Predict", "Label", "StatPos", "StatNeg"))
def _auc(ctx, ins, attrs):
    """Streaming AUC over threshold buckets: the positive and negative
    scores histogrammed into num_thresholds + 1 buckets, then the ROC
    curve integrated by trapezoids (or the PR curve by right endpoints).
    slide_steps 0 accumulates over every batch; slide_steps S keeps the
    last S batches' histograms as a shift register and integrates their
    sum.  The float32 histograms hold integer counts, so the scatter's
    sums are exact in any order below 2^24."""
    predict = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    num_thresholds = attrs.get("num_thresholds", 4095)
    slide_steps = int(attrs.get("slide_steps", 0))
    curve = str(attrs.get("curve", "ROC")).upper()
    if curve not in ("ROC", "PR"):
        raise ValueError("auc: unsupported curve %r (ROC or PR)" % curve)
    if predict.dim() > 2 or (predict.dim() == 2 and predict.shape[1] > 2):
        raise ValueError(
            "auc: Predict must be [N] scores or [N, 2] binary "
            "probabilities, got %s" % (tuple(predict.shape),))
    pos_score = (predict[:, 1] if predict.dim() == 2 and predict.shape[1] == 2
                 else predict.reshape(-1))
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    bucket = torch.clamp((pos_score * num_thresholds).to(torch.int32), 0,
                         num_thresholds).long()
    is_pos = (label > 0).to(stat_pos.dtype)
    nb = num_thresholds + 1
    cur_pos = stat_pos.new_zeros(nb).index_put((bucket,), is_pos,
                                               accumulate=True)
    cur_neg = stat_neg.new_zeros(nb).index_put((bucket,), 1.0 - is_pos,
                                               accumulate=True)
    if slide_steps > 0:
        sp = stat_pos.reshape(slide_steps, nb)
        sn = stat_neg.reshape(slide_steps, nb)
        pos_state = torch.cat([sp[1:], cur_pos[None]], 0)
        neg_state = torch.cat([sn[1:], cur_neg[None]], 0)
        new_pos, new_neg = pos_state.sum(0), neg_state.sum(0)
    else:
        pos_state = new_pos = stat_pos.reshape(-1) + cur_pos
        neg_state = new_neg = stat_neg.reshape(-1) + cur_neg
    # descending thresholds
    tp = torch.cumsum(torch.flip(new_pos, (0,)), 0)
    fp = torch.cumsum(torch.flip(new_neg, (0,)), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    tp_prev = torch.cat([tp.new_zeros(1), tp[:-1]])
    fp_prev = torch.cat([fp.new_zeros(1), fp[:-1]])
    one = tp.new_ones(())
    if curve == "PR":
        recall = tp / torch.maximum(tot_pos, one)
        recall_prev = tp_prev / torch.maximum(tot_pos, one)
        precision = tp / torch.maximum(tp + fp, one)
        area = torch.sum((recall - recall_prev) * precision)
        auc = torch.where(tot_pos > 0, area, torch.zeros_like(area))
    else:
        area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        both = tot_pos * tot_neg
        auc = torch.where(both > 0, area / torch.maximum(both, one),
                          torch.zeros_like(area))
    return {"AUC": [auc],
            "StatPosOut": [pos_state.reshape(stat_pos.shape)],
            "StatNegOut": [neg_state.reshape(stat_neg.shape)]}
