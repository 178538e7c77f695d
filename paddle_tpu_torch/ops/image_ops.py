"""Image op lowerings (the counterpart of ``paddle_tpu/ops/image_ops.py``),
limited to the op of the in-graph preprocessing program:
``random_crop``."""

import torch

from ..core.registry import register


@register("random_crop", no_grad_inputs=("Seed",))
def _random_crop(ctx, ins, attrs):
    """A window of `shape` over X's trailing dims; leading dims are not
    cropped.  One start is drawn per cropped dim, uniform over the
    in-range offsets, and shared by the whole batch; the draws come from
    the op's generator (``LowerCtx.rng``), so they differ from the
    reference's threefry draws and follow the run's seed and step.  The
    crop gathers at device-side offsets (``index_select``), so a captured
    step draws anew at every replay.  SeedOut is a zero, as the
    reference's."""
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    lead = x.dim() - len(shape)
    if lead < 0 or any(s < 1 or s > x.shape[lead + i]
                       for i, s in enumerate(shape)):
        raise ValueError("random_crop: crop %s does not fit X %s"
                         % (shape, tuple(x.shape)))
    g = ctx.rng(attrs)
    out = x
    for i, s in enumerate(shape):
        d = lead + i
        start = torch.randint(0, x.shape[d] - s + 1, (1,), generator=g,
                              device=x.device)
        out = out.index_select(d, start + torch.arange(s, device=x.device))
    return {"Out": [out],
            "SeedOut": [torch.zeros(1, dtype=torch.int32, device=x.device)]}
