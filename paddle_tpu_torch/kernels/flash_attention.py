"""flash_attention_qvec (forward): per-row offset-causal attention, the
ragged serving step's attention.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``flash_attention_qvec``
(``_flash_fwd`` with ``qvec``, kernel body ``_flash_fwd_kernel``); the
CUDA kernel is ``csrc/flash_attention_qvec.cu``.
``flash_attention_qvec_plain`` is the plain PyTorch version (the dense
vector-QStart branch of the reference's ``fused_attention`` lowering,
``paddle_tpu/ops/nn_ops.py``): CPU and meta tensors take it, CUDA
tensors launch the kernel.  The backward (dq, dk/dv) is still to be
ported, see ROADMAP.
"""

import torch

from . import build

__all__ = ["flash_attention_qvec", "flash_attention_qvec_plain", "NEG_INF"]

NEG_INF = -1e30
# the kernel's fixed key split: keys in slices of this many (a multiple
# of its 32-key tile), merged by log-sum-exp in slice order
KV_CHUNK = 128


def flash_attention_qvec_plain(q, k, v, qstart, scale=None):
    """q [BH, Tq, d], k/v [BH, Tk, d], qstart [BH] int: query i of row b
    attends keys 0 .. qstart[b] + i."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * float(scale)
    q_pos = (qstart.reshape(bh, 1).long()
             + torch.arange(tq, device=q.device)[None, :])
    keep = q_pos[:, :, None] >= torch.arange(tk, device=q.device)[None, None, :]
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)


def flash_attention_qvec(q, k, v, qstart, scale=None):
    """Per-row-qstart causal attention; see flash_attention_qvec_plain."""
    if not build.use_kernel(q):
        return flash_attention_qvec_plain(q, k, v, qstart, scale)
    build.check_inputs("flash_attention_qvec", q, k, v)
    bh, tq, d = q.shape
    tk = k.shape[1]
    if (tuple(k.shape) != (bh, tk, d) or tuple(v.shape) != (bh, tk, d)
            or qstart.numel() != bh):
        raise ValueError("flash_attention_qvec: shapes q %s k %s v %s qstart "
                         "%s" % (tuple(q.shape), tuple(k.shape),
                                 tuple(v.shape), tuple(qstart.shape)))
    if d not in (64, 128):
        raise ValueError("flash_attention_qvec: the CUDA kernel is built for "
                         "head dims 64 and 128, got %d" % d)
    slices = -(-tk // KV_CHUNK) if tk > KV_CHUNK else 1
    if max(q.numel(), k.numel(), q.numel() * slices) >= 2 ** 31:
        raise ValueError("flash_attention_qvec: operands exceed the "
                         "kernel's 32-bit row indexing")
    if scale is None:
        scale = d ** -0.5
    qs = qstart.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    part_o = part_ml = None
    if slices > 1:
        part_o = torch.empty((bh, tq, slices, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((bh, tq, slices, 2), dtype=torch.float32,
                              device=q.device)
    build.launch("ptt_flash_attention_qvec", q, k, v, qs, out, part_o, part_ml,
                 bh, tq, tk, d, KV_CHUNK, float(scale))
    flash_attention_qvec.launches += 1
    return out


flash_attention_qvec.launches = 0
