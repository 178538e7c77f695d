"""Flash attention: the training form (forward, dq, dk/dv), the
chunked-decode / ring piece (forward, dq, dk/dv with a scalar query
offset) and the per-row offset-causal serving form (forward, dq,
dk/dv with a per-row query base).

``flash_attention`` replaces ``paddle_tpu/ops/pallas_kernels.py``
``flash_attention``: the forward ``_flash_fwd`` (kernel body
``_flash_fwd_kernel``) and the backward ``_flash_bwd``, whose dq and
dk/dv calls run ``_flash_dq_kernel`` and ``_flash_dkv_kernel``.  The
CUDA kernels are ``csrc/flash_attention.cu``.  Over q [BH, Tq, d] and
k, v [BH, Tk, d] with an optional additive key bias [BH, Tk], causal
masking, an optional sliding window and optional segment ids:

    s = q k^T * scale + kbias,   lse = logsumexp(s),   o = exp(s - lse) v

and the backward rebuilds p = exp(s - lse) from the saved lse:

    delta = rowsum(o * do) - dlse,   ds = p * (do v^T - delta),
    dq = scale * ds k,   dk = scale * ds^T q,   dv = p^T do,
    dkbias = column sums of ds,

where dlse, the cotangent of the lse output, is zero except for the
piece.  Causal masking is in global positions: query i of head row b
sits at p = base(b) + i and sees keys 0 .. p; a window w > 0 (causal
only, the reference's ``_band``) keeps the keys j with p - j < w, and
segment ids seg [BH, T] (sequence packing: Tq == Tk, no base) keep the
keys whose id equals the query's.  A row that sees no key (a window
past a piece's keys) keeps lse = NEG_INF, takes zero gradients, and its
o is defined-garbage, as in the reference.  The three forms differ only
in the base, which the same three kernels read on the device (no host
sync on a position):

- ``flash_attention`` (B3): base 0, Tq == Tk when causal; the window
  and the segment ids, alone or together;
- ``flash_attention_piece`` (B9, the reference's ``flash_attention_piece``:
  ``_flash_fwd``/``_flash_bwd`` with a scalar ``qoff``): one offset for
  every row, Tq != Tk allowed, with an optional window; returns (o,
  lse), differentiable through both (the lse cotangent folds into
  delta, as ``_flash_bwd`` does);
- the few-row form of B3's forward (B3d, ``flash_attention_fwd_rows``,
  ``csrc/flash_attention_rows.cu``): ``flash_attention_fwd`` hands it
  the decode steps' calls, Tq <= ``ROWS_MAX_TQ`` with or without a key
  bias and no other mask (``rows_form``); the keys are cut into fixed
  slices (``rows_plan``, a function of Tk and d only), one block a
  (head row, slice), merged by log-sum-exp in slice order.  Its
  launches count on its own counter, the tile kernel's on
  ``flash_attention_fwd``'s;
- ``flash_attention_qvec`` (B8, ``_flash_fwd``/``_flash_bwd`` with
  ``qvec``): a [BH] base per row.  Its forward is
  ``csrc/flash_attention_qvec.cu`` (B8a), the serving step's few rows
  over a long cache: one block a (head row, 16-query tile, key slice),
  each warp a ring of ``cp.async``-staged key chunks, both products on
  3xTF32 ``mma.sync``, the warps merged in order and the slices by
  log-sum-exp in slice order, cut as ``qvec_plan`` says (a function of
  Tk and d only).  It gives the lse the backward needs only when a
  gradient is wanted; the serving step asks for none.

``flash_attention_plain`` (o, lse) and ``flash_attention_grad_plain``
(dq, dk, dv, dkbias) are the plain PyTorch versions of all three (the
reference's ``_dense_attention``, with its lse and its segment mask);
``flash_attention_piece_plain`` and ``flash_attention_piece_grad_plain``
name the piece's, ``flash_attention_qvec_plain`` the serving forward's.
CPU and meta tensors take them, CUDA tensors launch the kernels or
raise.  The tile kernels run each launch in the form flash_plan gives
(a function of the shape): 3xTF32 tensor-core tiles at head dim 64,
SIMT FP32 tiles at 128.  The forms are ``torch.autograd.Function``s
(the reference's ``jax.custom_vjp``): the forward saves o and lse, the backward launches
dq and dk/dv in a nested function.  Each form counts its own launches.

bf16: the training form's three kernels have bf16 forms
(``csrc/flash_attention_bf16.cu``: bf16 q, k, v and dO; the key bias,
lse and delta float32; o, dq, dk, dv rounded once from float32
accumulators; bf16 ``mma.sync`` tiles at head dim 64, the SIMT form
widening its operands at 128), counted under
``flash_attention_{fwd,dq,dkv}_bf16``.  ``flash_plan`` gives the same
form for a shape in both dtypes.  The plain versions follow the Pallas
kernels' arithmetic in bf16: q, k and v widened before the score
product, p and dS float32 in the second products, each output rounded
once.

bf16 KV caches: the forwards that read a cache (the few-row form B3d,
the piece B9, the qvec form B8) have bf16-KV forms, which take a
float32 q with bf16 k and v, as the reference's cached attention hands
them to ``_flash_fwd``: o and lse float32, the key bias float32.  Each
kernel stages the bf16 keys and values in 16-byte copies and widens
them where it reads them (exact, also in TF32), so it computes what the
float32 form computes over the widened cache; the plans take the
dtype (``rows_plan``, ``qvec_plan``: the staged chunks' shared memory).
They count under ``flash_attention_fwd_rows_kvbf16``,
``flash_attention_piece_fwd_kvbf16`` and ``flash_attention_qvec_kvbf16``.
A bf16 q to these kernels, and bf16 k or v to the piece's and the qvec
form's backwards, raise KernelTypeError (ROADMAP B8q).
"""

import collections

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain", "attention_scores",
           "flash_attention_grad_plain", "flash_attention_fwd", "flash_plan",
           "flash_attention_fwd_rows", "rows_form", "rows_plan", "qvec_plan",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_piece", "flash_attention_piece_plain",
           "flash_attention_piece_grad_plain", "flash_attention_piece_fwd",
           "flash_attention_piece_dq", "flash_attention_piece_dkv",
           "flash_attention_qvec", "flash_attention_qvec_plain",
           "flash_attention_qvec_dq", "flash_attention_qvec_dkv",
           "flash_attention_fwd_bf16", "flash_attention_dq_bf16",
           "flash_attention_dkv_bf16", "flash_attention_fwd_rows_kvbf16",
           "flash_attention_piece_fwd_kvbf16", "flash_attention_qvec_kvbf16",
           "NEG_INF"]

NEG_INF = -1e30
# the qvec forward's split (qvec_plan): QVEC_WARPS[d] warps a block (8
# do not fit the shared memory at d 128), each walking chunks of
# QVEC_CHUNK keys, in slices of QVEC_SLICE keys merged by log-sum-exp in
# slice order; the split measured fastest at the serving steps' shapes
# on the card, full caches and a pool's mixed ones
# (scripts/qvec_forms_check.py)
QVEC_CHUNK = 16
QVEC_WARPS = {64: 8, 128: 4}
QVEC_SLICE = 1024
QVEC_ROWS = 16  # query rows of the kernel's tile
# the few-row forward: at most this many query rows; keys cut into about
# ROWS_SLICES slices of 128 to ROWS_SLICE_MAX[d] keys (a multiple of 32:
# one 32-key chunk a warp, at most 8 warps, 4 at d 128 for shared memory
# in float32; the bf16-KV form's chunks take half the bytes, so 8 fit at
# d 128 too), the split measured fastest at the decode steps' shapes on
# the card (scripts/decode_kernels_check.py)
ROWS_MAX_TQ = 8
ROWS_SLICES = 8
ROWS_SLICE_MIN = 128
ROWS_SLICE_MAX = {64: 256, 128: 128}
ROWS_SLICE_MAX_KV16 = {64: 256, 128: 256}

RowsPlan = collections.namedtuple("RowsPlan", "slice_len slices")
QvecPlan = collections.namedtuple("QvecPlan", "warps slice_len slices smem")
# the tile kernels' forms: 3xTF32 tensor-core tiles and SIMT FP32 tiles
# (flash_plan chooses)
FLASH_SIMT, FLASH_TC = 0, 1


def rows_form(tq, causal=False, window=0, seg=None):
    """Whether B3's forward takes the few-row kernel: the decode steps'
    calls, Tq <= ROWS_MAX_TQ, not causal, no window and no segment ids
    (a key bias or none).  The based forms (B8, B9) never do."""
    return (0 < tq <= ROWS_MAX_TQ and not causal and not window
            and seg is None)


def rows_plan(tk, d, kv_dtype=torch.float32):
    """The few-row kernel's fixed key split for Tk keys at head dim d over
    keys and values of `kv_dtype` (float32, or bf16 in the bf16-KV form):
    (slice_len, slices).  About ROWS_SLICES slices, each a multiple of 32
    keys in [ROWS_SLICE_MIN, ROWS_SLICE_MAX[d]] (ROWS_SLICE_MAX_KV16 in
    bf16), or one slice of Tk rounded up to 32 where Tk is shorter.
    Depends on Tk, d and the dtype alone, never on the rows or the bias,
    so a row's bits do not depend on its batch."""
    most = (ROWS_SLICE_MAX_KV16 if kv_dtype == torch.bfloat16
            else ROWS_SLICE_MAX)[d]
    per = 32 * -(-tk // (32 * ROWS_SLICES))
    slice_len = min(max(per, ROWS_SLICE_MIN), most, 32 * -(-tk // 32))
    return RowsPlan(slice_len, -(-tk // slice_len))


def qvec_smem(d, warps, kv_dtype=torch.float32):
    """Bytes of dynamic shared memory of the qvec forward's block: the
    split q tile (big and small words), each warp's ring of two K and V
    chunks of `kv_dtype` (2 bytes an element in the bf16-KV form), each
    warp's (m, l) a row; the kernel checks it against its own layout."""
    kv_bytes = 2 if kv_dtype == torch.bfloat16 else 4
    return (4 * (2 * QVEC_ROWS * d + warps * QVEC_ROWS * 2)
            + kv_bytes * warps * 2 * 2 * QVEC_CHUNK * d)


def qvec_plan(tk, d, warps=None, slice_len=QVEC_SLICE,
              kv_dtype=torch.float32):
    """The qvec forward's split of Tk keys at head dim d: (warps,
    slice_len, slices, smem), handed to the kernel as ints.  Slices of
    `slice_len` keys (a multiple of the 16-key chunk; one slice of Tk
    rounded up to the chunk where Tk is shorter), at most one warp a
    chunk of the slice.  Both head dims run the 3xTF32 tensor-core form;
    `kv_dtype` bf16 (the bf16-KV form) stages half the bytes, the same
    split.  Depends on Tk, d and the dtype alone, never on BH, the query
    bases or the data, so a row's bits do not depend on its batch.  The
    keyword arguments are the candidates scripts/qvec_forms_check.py
    times."""
    c = QVEC_CHUNK
    slice_len = min(c * -(-slice_len // c), c * -(-tk // c))
    warps = min(QVEC_WARPS[d] if warps is None else warps, slice_len // c)
    return QvecPlan(warps, slice_len, -(-tk // slice_len),
                    qvec_smem(d, warps, kv_dtype))


def flash_plan(kernel, tq, tk, d):
    """The form of one tile kernel ("fwd", "dq" or "dkv") at a shape,
    handed to it as one int; each form fixes its tiles in the kernel
    source.  Head dim 64 takes the tensor-core form (128-row blocks; the
    forward walks 64-key tiles, dq 32-key tiles, dk/dv 32-query tiles),
    except dq at a shape with at most 64 queries and 64 keys (WMT's
    512 x 64 x 64): there a 128-row block runs half its warps idle over
    two key tiles, and the SIMT form measured faster on the card
    (scripts/flash_attention_forms_check.py).  Head dim 128 takes the
    SIMT form (64-row blocks walking 64-key tiles, dk/dv 32-query tiles),
    whose resident operands fit the registers.  A function of the shape
    alone, never of the data, the masks or the query base; the bf16
    forms take the same rule (their tensor-core tiles are bf16
    ``mma.sync``, their SIMT form widens the operands)."""
    if d == 64 and (kernel != "dq" or tq > 64 or tk > 64):
        return FLASH_TC
    return FLASH_SIMT


def _check_form(name, tq, tk, causal, qbase, window, seg):
    """The masks the kernels take, as the reference asserts them: a
    window needs causal; segment ids need Tq == Tk and no query base."""
    if window < 0:
        raise build.KernelInputError("%s: window must be >= 0, got %d"
                                     % (name, window))
    if window and not causal:
        raise build.KernelInputError("%s: a window requires causal=True"
                                     % name)
    if seg is not None and (qbase is not None or tq != tk):
        raise build.KernelInputError("%s: segment ids require Tq == Tk and no "
                                     "query base" % name)


def attention_scores(q, k, kbias, causal, scale, qbase=None, window=0,
                     seg=None):
    """[BH, Tq, Tk] float32 scores with the key bias, the causal and
    window masks and the segment mask (NEG_INF) applied; query i of row
    b at global position qbase[b] + i (a one-element qbase serves every
    row), keys at their indices; seg [BH, T] segment ids.  q and k are
    widened to float32 before the product, as the Pallas kernels do (a
    no-op in float32; bf16 products are exact there)."""
    _check_form("attention_scores", q.shape[1], k.shape[1], causal, qbase,
                int(window), seg)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * float(scale)
    if kbias is not None:
        s = s + kbias[:, None, :].float()
    if seg is not None:
        s = torch.where(seg[:, :, None] == seg[:, None, :], s,
                        torch.full((), NEG_INF, device=q.device))
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = torch.arange(tq, device=q.device)[None, :]
        if qbase is not None:
            q_pos = qbase.reshape(-1, 1).to(q.device).long() + q_pos
        gap = q_pos[:, :, None] - torch.arange(tk, device=q.device)
        keep = gap >= 0
        if window:
            keep = keep & (gap < int(window))
        s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    return s


def flash_attention_plain(q, k, v, kbias=None, causal=False, scale=None,
                          qbase=None, window=0, seg=None):
    """(o [BH, Tq, d], lse [BH, Tq] float32).  Where a row's scores sit
    at one large bias (every one at NEG_INF, or at -1e9, under which
    float32 loses the scores), log(l) rounds away: lse equals the row's
    max and exp(s - lse) would weigh each top key by 1.  Those rows are
    renormalized, weighing the keys alike as _flash_fwd_kernel's acc / l
    and the reference's softmax do; every other row keeps exp(s - lse)
    bit for bit.  p stays float32 for p v over the widened v and o is
    rounded once to q's dtype: the Pallas kernel's arithmetic in bf16,
    where the reference's dense path would round p first."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = attention_scores(q, k, kbias, causal, scale, qbase, window, seg)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    p = torch.where((lse == s.amax(-1))[..., None],
                    p / p.sum(-1, keepdim=True), p)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype), lse


def flash_attention_grad_plain(q, k, v, kbias, lse, do, delta, causal=False,
                               scale=None, qbase=None, window=0, seg=None):
    """(dq, dk, dv, dkbias [BH, Tk] float32) from the saved lse and
    delta = rowsum(o * do) - dlse; rows whose lse is the NEG_INF
    sentinel take no gradient (the reference's guard)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = attention_scores(q, k, kbias, causal, scale, qbase, window, seg)
    lse = lse.float()[..., None]
    p = torch.where(lse <= NEG_INF / 2, torch.zeros((), device=q.device),
                    torch.exp(s - lse))
    dof = do.float()
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta.float()[..., None])
    dq = float(scale) * torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = float(scale) * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(1))


def _delta(o, do, dlse=None):
    """rowsum(o * do) - dlse: the backward's per-row term, with the lse
    cotangent folded in."""
    delta = (do.float() * o.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def flash_attention_piece_plain(q, k, v, causal=False, scale=None, qoff=None,
                                window=0):
    """The piece's (o, lse): attention of the query chunk at global
    offset qoff (a one-element int tensor) against one K/V chunk, o
    normalized within the chunk."""
    return flash_attention_plain(q, k, v, None, causal, scale, qoff, window)


def flash_attention_piece_grad_plain(q, k, v, o, lse, do, dlse, causal=False,
                                     scale=None, qoff=None, window=0):
    """The piece's (dq, dk, dv) from the cotangents of both outputs."""
    return flash_attention_grad_plain(q, k, v, None, lse, do,
                                      _delta(o, do, dlse), causal, scale,
                                      qoff, window)[:3]


def _check(name, q, k, v, kbias, causal, qbase, window, seg, *rows):
    build.check_inputs(name, q, k, v, *rows,
                       *(() if kbias is None else (kbias,)))
    bh, tq, d = q.shape
    tk = k.shape[1]
    if (tuple(k.shape) != (bh, tk, d) or tuple(v.shape) != (bh, tk, d)
            or (kbias is not None and tuple(kbias.shape) != (bh, tk))
            or (seg is not None and tuple(seg.shape) != (bh, tk))):
        raise build.KernelInputError(
            "%s: shapes q %s k %s v %s kbias %s seg %s" % (
                name, tuple(q.shape), tuple(k.shape), tuple(v.shape),
                None if kbias is None else tuple(kbias.shape),
                None if seg is None else tuple(seg.shape)))
    _check_form(name, tq, tk, causal, qbase, window, seg)
    if seg is not None and (seg.is_floating_point()
                            or seg.device != q.device):
        raise build.KernelInputError("%s: segment ids must be an integer "
                                     "tensor on %s" % (name, q.device))
    if causal and qbase is None and tq != tk:
        raise build.KernelInputError("%s: causal requires Tq == Tk, got %d vs "
                                     "%d" % (name, tq, tk))
    if qbase is not None and qbase.numel() not in (1, bh):
        raise build.KernelInputError(
            "%s: the query base has %d entries, not 1 or BH = %d"
            % (name, qbase.numel(), bh))
    if d not in (64, 128):
        raise build.KernelInputError("%s: the CUDA kernels are built for head "
                                     "dims 64 and 128, got %d" % (name, d))
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise build.KernelInputError("%s: operands exceed the kernels' 32-bit "
                                     "row indexing" % name)
    if any(t.data_ptr() % 16 for t in (q, k, v, *rows) if t.dim() == 3):
        raise build.KernelInputError("%s: q, k, v (and dO) must start on 16 "
                                     "bytes (the kernels stage their rows in "
                                     "16-byte copies)" % name)
    return bh, tq, tk, d


def _qbase_arg(qbase, device):
    """(int32 tensor on the device, stride): stride 0 reads one offset
    for every row, stride 1 one base per row; a device-side cast, no
    host sync."""
    if qbase is None:
        return None, 0
    qb = qbase.reshape(-1).to(device=device, dtype=torch.int32).contiguous()
    return qb, int(qb.numel() > 1)


def _seg_arg(seg):
    """The [BH, T] segment ids as int32 on their device, or None."""
    if seg is None:
        return None
    return seg.to(dtype=torch.int32).contiguous()


def _fwd(name, q, k, v, kbias, causal, scale, qbase=None, window=0,
         seg=None):
    bh, tq, tk, d = _check(name, q, k, v, kbias, causal, qbase, window, seg)
    if scale is None:
        scale = d ** -0.5
    qb, stride = _qbase_arg(qbase, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    # the bf16 entry point takes only the training form's calls, the
    # bf16-KV one only the piece's: check_inputs refuses the others
    fn = ("ptt_flash_attention_fwd_bf16" if q.dtype == torch.bfloat16
          else "ptt_flash_attention_fwd_kvbf16" if k.dtype == torch.bfloat16
          else "ptt_flash_attention_fwd")
    build.launch(fn, q, k, v, kbias, qb, o,
                 lse, bh, tq, tk, d, flash_plan("fwd", tq, tk, d),
                 int(bool(causal)), stride, float(scale), int(window),
                 _seg_arg(seg))
    return o, lse


def _dq(name, q, k, v, kbias, lse, do, delta, causal, scale, qbase=None,
        window=0, seg=None):
    bh, tq, tk, d = _check(name, q, k, v, kbias, causal, qbase, window, seg,
                           lse, do, delta)
    if scale is None:
        scale = d ** -0.5
    qb, stride = _qbase_arg(qbase, q.device)
    dq = torch.empty_like(q)
    build.launch("ptt_flash_attention_dq_bf16" if q.dtype == torch.bfloat16
                 else "ptt_flash_attention_dq", q, k, v, kbias, qb, lse,
                 do, delta, dq, bh, tq, tk, d, flash_plan("dq", tq, tk, d),
                 int(bool(causal)), stride, float(scale), int(window),
                 _seg_arg(seg))
    return dq


def _dkv(name, q, k, v, kbias, lse, do, delta, causal, scale, qbase=None,
         window=0, seg=None):
    bh, tq, tk, d = _check(name, q, k, v, kbias, causal, qbase, window, seg,
                           lse, do, delta)
    if scale is None:
        scale = d ** -0.5
    qb, stride = _qbase_arg(qbase, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dkb = (torch.empty((bh, tk), dtype=torch.float32, device=q.device)
           if kbias is not None else None)
    build.launch("ptt_flash_attention_dkv_bf16" if q.dtype == torch.bfloat16
                 else "ptt_flash_attention_dkv", q, k, v, kbias, qb, lse,
                 do, delta, dk, dv, dkb, bh, tq, tk, d,
                 flash_plan("dkv", tq, tk, d), int(bool(causal)), stride,
                 float(scale), int(window), _seg_arg(seg))
    return dk, dv, dkb


def flash_attention_fwd_rows(q, k, v, kbias=None, scale=None):
    """B3's forward in its few-row form (B3d): (o, lse) of q [BH, Tq <=
    ROWS_MAX_TQ, d] over k/v [BH, Tk, d] with an optional key bias, no
    other mask, at rows_plan's split; k and v start on 16 bytes.  bf16
    k and v beside a float32 q take the bf16-KV form."""
    if not build.use_kernel(q):
        return flash_attention_plain(q, k, v, kbias, False, scale)
    bh, tq, tk, d = _check("flash_attention_fwd_rows", q, k, v, kbias, False,
                           None, 0, None)
    if not rows_form(tq):
        raise build.KernelInputError("flash_attention_fwd_rows: Tq %d is not "
                                     "in 1 .. %d" % (tq, ROWS_MAX_TQ))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise build.KernelInputError("flash_attention_fwd_rows: k and v must "
                                     "start on 16 bytes (the kernel stages "
                                     "them in 16-byte copies)")
    if scale is None:
        scale = d ** -0.5
    kv16 = k.dtype == torch.bfloat16  # check_inputs: with a float32 q
    plan = rows_plan(tk, d, k.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    part_o = part_ml = None
    if plan.slices > 1:
        part_o = torch.empty((bh, tq, plan.slices, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((bh, tq, plan.slices, 2), dtype=torch.float32,
                              device=q.device)
    build.launch("ptt_flash_attention_rows_kvbf16" if kv16
                 else "ptt_flash_attention_rows", q, k, v, kbias, o, lse,
                 part_o, part_ml, bh, tq, tk, d, *plan, float(scale))
    (flash_attention_fwd_rows_kvbf16 if kv16
     else flash_attention_fwd_rows).launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, kbias=None, causal=False, scale=None,
                        window=0, seg=None):
    """B3's forward kernel: (o, lse).  The decode steps' few-row calls
    (rows_form) take flash_attention_fwd_rows, which counts them; this
    entry point counts the tile kernel's launches only.  Both kernels
    need their operands to start on 16 bytes: a contiguous [BH, T, d]
    at d 64 or 128 cut along BH or T from an allocation always does, a
    view at some other offset raises."""
    if not build.use_kernel(q):
        return flash_attention_plain(q, k, v, kbias, causal, scale, None,
                                     window, seg)
    if rows_form(q.shape[1], causal, window, seg):
        return flash_attention_fwd_rows(q, k, v, kbias, scale)
    out = _fwd("flash_attention_fwd", q, k, v, kbias, causal, scale, None,
               window, seg)
    (flash_attention_fwd_bf16 if q.dtype == torch.bfloat16
     else flash_attention_fwd).launches += 1
    return out


def flash_attention_dq(q, k, v, kbias, lse, do, delta, causal=False,
                       scale=None, window=0, seg=None):
    """B3's dq kernel: one block per query tile walks the key tiles in
    order (flash_plan's tiles)."""
    if not build.use_kernel(q):
        return flash_attention_grad_plain(q, k, v, kbias, lse, do, delta,
                                          causal, scale, None, window,
                                          seg)[0]
    dq = _dq("flash_attention_dq", q, k, v, kbias, lse, do, delta, causal,
             scale, None, window, seg)
    (flash_attention_dq_bf16 if q.dtype == torch.bfloat16
     else flash_attention_dq).launches += 1
    return dq


def flash_attention_dkv(q, k, v, kbias, lse, do, delta, causal=False,
                        scale=None, window=0, seg=None):
    """B3's dk/dv kernel: (dk, dv, dkbias or None); one block per key
    tile walks the query tiles in order (flash_plan's tiles)."""
    if not build.use_kernel(q):
        _, dk, dv, dkb = flash_attention_grad_plain(q, k, v, kbias, lse, do,
                                                    delta, causal, scale,
                                                    None, window, seg)
        return dk, dv, (dkb if kbias is not None else None)
    out = _dkv("flash_attention_dkv", q, k, v, kbias, lse, do, delta, causal,
               scale, None, window, seg)
    (flash_attention_dkv_bf16 if q.dtype == torch.bfloat16
     else flash_attention_dkv).launches += 1
    return out


def flash_attention_piece_fwd(q, k, v, causal=False, scale=None, qoff=None,
                              window=0):
    """B9's forward: the based forward kernel with one offset for every
    row; (o, lse).  bf16 k and v beside a float32 q take its bf16-KV
    form."""
    if not build.use_kernel(q):
        return flash_attention_piece_plain(q, k, v, causal, scale, qoff,
                                           window)
    out = _fwd("flash_attention_piece_fwd", q, k, v, None, causal, scale,
               qoff, window)
    (flash_attention_piece_fwd_kvbf16 if k.dtype == torch.bfloat16
     else flash_attention_piece_fwd).launches += 1
    return out


def flash_attention_piece_dq(q, k, v, lse, do, delta, causal=False,
                             scale=None, qoff=None, window=0):
    """B9's dq: the based dq kernel with one offset for every row."""
    if not build.use_kernel(q):
        return flash_attention_grad_plain(q, k, v, None, lse, do, delta,
                                          causal, scale, qoff, window)[0]
    dq = _dq("flash_attention_piece_dq", q, k, v, None, lse, do, delta,
             causal, scale, qoff, window)
    flash_attention_piece_dq.launches += 1
    return dq


def flash_attention_piece_dkv(q, k, v, lse, do, delta, causal=False,
                              scale=None, qoff=None, window=0):
    """B9's dk/dv: (dk, dv) from the based dk/dv kernel."""
    if not build.use_kernel(q):
        return flash_attention_grad_plain(q, k, v, None, lse, do, delta,
                                          causal, scale, qoff, window)[1:3]
    dk, dv, _ = _dkv("flash_attention_piece_dkv", q, k, v, None, lse, do,
                     delta, causal, scale, qoff, window)
    flash_attention_piece_dkv.launches += 1
    return dk, dv


def flash_attention_qvec_dq(q, k, v, lse, do, delta, qstart, scale=None):
    """B8's dq: the based dq kernel with one base per row (causal)."""
    if not build.use_kernel(q):
        return flash_attention_grad_plain(q, k, v, None, lse, do, delta, True,
                                          scale, qstart)[0]
    dq = _dq("flash_attention_qvec_dq", q, k, v, None, lse, do, delta, True,
             scale, qstart)
    flash_attention_qvec_dq.launches += 1
    return dq


def flash_attention_qvec_dkv(q, k, v, lse, do, delta, qstart, scale=None):
    """B8's dk/dv: (dk, dv) from the based dk/dv kernel, one base per
    row (causal)."""
    if not build.use_kernel(q):
        return flash_attention_grad_plain(q, k, v, None, lse, do, delta, True,
                                          scale, qstart)[1:3]
    dk, dv, _ = _dkv("flash_attention_qvec_dkv", q, k, v, None, lse, do,
                     delta, True, scale, qstart)
    flash_attention_qvec_dkv.launches += 1
    return dk, dv


# the bf16 and bf16-KV forms' launches count apart from the float32 forms'
flash_attention_fwd_bf16 = build.LaunchCount("flash_attention_fwd_bf16")
flash_attention_dq_bf16 = build.LaunchCount("flash_attention_dq_bf16")
flash_attention_dkv_bf16 = build.LaunchCount("flash_attention_dkv_bf16")
flash_attention_fwd_rows_kvbf16 = build.LaunchCount(
    "flash_attention_fwd_rows_kvbf16")
flash_attention_piece_fwd_kvbf16 = build.LaunchCount(
    "flash_attention_piece_fwd_kvbf16")
flash_attention_qvec_kvbf16 = build.LaunchCount("flash_attention_qvec_kvbf16")


for _fn in (flash_attention_fwd, flash_attention_fwd_rows,
            flash_attention_dq, flash_attention_dkv,
            flash_attention_piece_fwd, flash_attention_piece_dq,
            flash_attention_piece_dkv, flash_attention_qvec_dq,
            flash_attention_qvec_dkv):
    _fn.launches = 0


def _flash_grad(form, q, k, v, kbias, qbase, lse, do, delta, causal, scale,
                window, seg):
    """(dq, dk, dv[, dkbias]) of one form ("flash", "piece", "qvec"):
    its dq and dk/dv kernels on CUDA tensors, one plain pass for all
    four otherwise."""
    if not build.use_kernel(q):
        dq, dk, dv, dkb = flash_attention_grad_plain(
            q, k, v, kbias, lse, do, delta, causal, scale, qbase, window,
            seg)
    elif form == "flash":
        dq = flash_attention_dq(q, k, v, kbias, lse, do, delta, causal, scale,
                                window, seg)
        dk, dv, dkb = flash_attention_dkv(q, k, v, kbias, lse, do, delta,
                                          causal, scale, window, seg)
    elif form == "piece":
        dq = flash_attention_piece_dq(q, k, v, lse, do, delta, causal, scale,
                                      qbase, window)
        dk, dv = flash_attention_piece_dkv(q, k, v, lse, do, delta, causal,
                                           scale, qbase, window)
    else:
        dq = flash_attention_qvec_dq(q, k, v, lse, do, delta, qbase, scale)
        dk, dv = flash_attention_qvec_dkv(q, k, v, lse, do, delta, qbase,
                                          scale)
    return (dq, dk, dv) if kbias is None else (dq, dk, dv, dkb)


class _FlashAttentionGrad(torch.autograd.Function):
    """(dq, dk, dv[, dkbias]) as a function of its own.  Under
    torch.func.vjp a backward sees wrapped tensors, which have no
    storage for a kernel to read; an autograd.Function's forward is
    handed the plain tensors underneath.  Not differentiable again."""

    @staticmethod
    def forward(form, q, k, v, kbias, qbase, lse, do, delta, causal, scale,
                window, seg):
        return _flash_grad(form, q, k, v, kbias, qbase, lse, do, delta,
                           causal, scale, window, seg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, kbias, causal, scale, window, seg):
        return flash_attention_fwd(q, k, v, kbias, causal, scale, window, seg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, kbias, causal, scale, window, seg = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, kbias, seg, o, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kbias, seg, o, lse = ctx.saved_tensors
        grads = _FlashAttentionGrad.apply(
            "flash", q, k, v, kbias, None, lse, do.contiguous(),
            _delta(o, do).contiguous(), ctx.causal, ctx.scale, ctx.window,
            seg)
        dkb = grads[3] if kbias is not None else None
        return grads[0], grads[1], grads[2], dkb, None, None, None, None


def flash_attention(q, k, v, kbias=None, causal=False, scale=None, window=0,
                    seg=None):
    """Attention over q [BH, Tq, d], k/v [BH, Tk, d] float32 or bf16, with
    an optional additive float32 key bias [BH, Tk], causal masking (Tq == Tk), an
    optional sliding window (causal only) and optional [BH, T] integer
    segment ids (Tq == Tk).  Differentiable in q, k, v and kbias (the
    backward runs the dq and dk/dv kernels on CUDA tensors); the segment
    ids take no gradient."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kbias, bool(causal), float(scale),
                                 int(window), seg)[0]


class _FlashAttentionPiece(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, qoff, causal, scale, window):
        return flash_attention_piece_fwd(q, k, v, causal, scale, qoff, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, qoff, causal, scale, window = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, qoff, o, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, qoff, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionGrad.apply(
            "piece", q, k, v, None, qoff, lse, do.contiguous(),
            _delta(o, do, dlse).contiguous(), ctx.causal, ctx.scale,
            ctx.window, None)
        return dq, dk, dv, None, None, None, None


def flash_attention_piece(q, k, v, causal=False, scale=None, qoff=None,
                          window=0):
    """(o, lse) of the query chunk q [BH, Tq, d] at global offset qoff (a
    one-element int tensor, read on the device; None is offset 0)
    against one K/V chunk k/v [BH, Tk, d], Tq != Tk allowed, with an
    optional sliding window in global positions; o is softmax-normalized
    within the chunk.  Differentiable in q, k and v through both
    outputs."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttentionPiece.apply(q, k, v, qoff, bool(causal),
                                      float(scale), int(window))


def flash_attention_qvec_plain(q, k, v, qstart, scale=None):
    """q [BH, Tq, d], k/v [BH, Tk, d], qstart [BH] int: query i of row b
    attends keys 0 .. qstart[b] + i."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * float(scale)
    q_pos = (qstart.reshape(bh, 1).long()
             + torch.arange(tq, device=q.device)[None, :])
    keep = q_pos[:, :, None] >= torch.arange(tk, device=q.device)[None, None, :]
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _qvec_forward(q, k, v, qstart, scale, with_lse):
    """The serving forward: o, or (o, lse) with `with_lse`, at
    qvec_plan's split."""
    if not build.use_kernel(q):
        if with_lse:
            return flash_attention_plain(q, k, v, None, True, scale, qstart)
        return flash_attention_qvec_plain(q, k, v, qstart, scale)
    build.check_inputs("flash_attention_qvec", q, k, v)
    kv16 = k.dtype == torch.bfloat16  # check_inputs: with a float32 q
    bh, tq, d = q.shape
    tk = k.shape[1]
    if (tuple(k.shape) != (bh, tk, d) or tuple(v.shape) != (bh, tk, d)
            or qstart.numel() != bh or tk == 0):
        raise build.KernelInputError(
            "flash_attention_qvec: shapes q %s k %s v %s qstart %s" % (
                tuple(q.shape), tuple(k.shape), tuple(v.shape),
                tuple(qstart.shape)))
    if d not in (64, 128):
        raise build.KernelInputError("flash_attention_qvec: the CUDA kernel "
                                     "is built for head dims 64 and 128, got "
                                     "%d" % d)
    plan = qvec_plan(tk, d, kv_dtype=k.dtype)
    if max(q.numel(), k.numel(), q.numel() * plan.slices) >= 2 ** 31:
        raise build.KernelInputError("flash_attention_qvec: operands exceed "
                                     "the kernel's 32-bit row indexing")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise build.KernelInputError("flash_attention_qvec: q, k and v must "
                                     "start on 16 bytes (the kernel stages "
                                     "them in 16-byte copies)")
    qs = qstart.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((bh, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    part_o = part_ml = None
    if plan.slices > 1:
        part_o = torch.empty((bh, tq, plan.slices, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((bh, tq, plan.slices, 2), dtype=torch.float32,
                              device=q.device)
    build.launch("ptt_flash_attention_qvec_kvbf16" if kv16
                 else "ptt_flash_attention_qvec", q, k, v, qs, out, lse,
                 part_o, part_ml, bh, tq, tk, d, *plan, float(scale))
    (flash_attention_qvec_kvbf16 if kv16
     else flash_attention_qvec).launches += 1
    return (out, lse) if with_lse else out


class _FlashAttentionQvec(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, qstart, scale):
        return _qvec_forward(q, k, v, qstart, scale, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, qstart, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, qstart, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, qstart, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionGrad.apply(
            "qvec", q, k, v, None, qstart, lse, do.contiguous(),
            _delta(o, do).contiguous(), True, ctx.scale, 0, None)
        return dq, dk, dv, None, None


def flash_attention_qvec(q, k, v, qstart, scale=None):
    """Per-row-qstart causal attention; see flash_attention_qvec_plain.
    Differentiable in q, k and v: where a gradient is wanted the forward
    also gives the lse, and the backward runs the based dq and dk/dv
    kernels on CUDA tensors.  Its launch count is the forward's; bf16 k
    and v beside a float32 q take the bf16-KV form, counted under
    flash_attention_qvec_kvbf16."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionQvec.apply(q, k, v, qstart, float(scale))[0]
    return _qvec_forward(q, k, v, qstart, float(scale), False)


flash_attention_qvec.launches = 0
