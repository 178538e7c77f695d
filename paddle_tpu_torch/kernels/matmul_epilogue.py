"""matmul_bias_act: [M, K] @ [K, N] + bias with the activation applied
to the float32 accumulator before the single store.

Replaces ``paddle_tpu/ops/pallas_kernels.py`` ``matmul_bias_act``
(kernel body ``_mm_kernel``, epilogue ``_mm_act``); the CUDA kernel is
``csrc/matmul_bias_act.cu``.  ``matmul_bias_act_plain`` is the plain
PyTorch version (the reference's ``_mm_dense``): CPU and meta tensors
take it, CUDA tensors launch the kernel.

``matmul_bias_act`` is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``): the forward launches the kernel, the backward is
the dense recompute of the reference's ``_mm_vjp_bwd`` (z = x @ w + b
again, then dz = dy act'(z), dx = dz w^T, dw = x^T dz, db = sum dz).
The JAX package has no backward kernel for it either.

bf16: x, w and bias bfloat16 (the AMP pass casts all three of fc's
slots) launch the kernel's bf16 form: z and the epilogue in float32,
the output rounded once to bfloat16.  The backward follows the
reference's ``jax.vjp`` of ``_mm_dense`` in dtype: dz in float32, its
products with the bf16 operands exact in float32, each grad rounded
once to its operand's dtype.
"""

import math
from typing import NamedTuple

import torch

from . import build

__all__ = ["matmul_bias_act", "matmul_bias_act_bf16", "matmul_bias_act_plain",
           "mm_act", "MM_ACTS", "mm_plan", "MmPlan"]

# the epilogue activations, in the kernel's enum order ("" is identity)
MM_ACTS = ("", "identity", "relu", "tanh", "sigmoid", "gelu", "swish")
_ACT_CODE = {"": 0, "identity": 0, "relu": 1, "tanh": 2, "sigmoid": 3,
             "gelu": 4, "swish": 5}

SMS = 132          # streaming multiprocessors of the H100 SXM: one wave
TILED, SKINNY = 0, 1
SKINNY_ROWS = 16   # the skinny form's most rows
K_STEP = 32        # a K slice is a multiple of the kernels' 32-deep stage
MIN_SLICE = 256    # the shallowest K slice a plan cuts
MAX_SLICES = 8     # a cluster along K: the portable cluster size
BLOCK_K = 128      # a block's fixed cost (its ring's fill, the cluster's
                   # sum) in k of its slice, as the plan counts it
# the tiled form's block tiles: rows, columns (of each product), blocks an
# SM holds at once, and the tile's rate an SM relative to the large one's
# in percent; large first: matmul_bias_act's and matmul_swiglu's
TILES = {False: ((128, 128, 1, 100), (64, 64, 2, 68)),
         True: ((128, 64, 1, 100), (64, 64, 2, 68))}
# blocks the H100 SXM holds at once in clusters of 1..8 along K, with one
# or two blocks an SM (cudaOccupancyMaxActiveClusters): a cluster lives in
# one GPC, so sizes that do not divide a GPC's SMs leave SMs idle
CLUSTER_BLOCKS = {1: (132, 132, 117, 120, 110, 102, 105, 120),
                  2: (264, 264, 237, 248, 235, 234, 224, 240)}
SKINNY_COLS = (128, 64, 32)  # the skinny form's column strips, wide first


class MmPlan(NamedTuple):
    """How ``csrc/matmul_bias_act.cu`` cuts [M, K] @ [K, N]; the C entry
    points take these five ints in this order.  form: TILED (3xTF32
    tensor-core tiles) or SKINNY (M <= 16: FP32 FMAs over column strips);
    bm, bn: the block's rows (SKINNY: M rounded up to a power of two) and
    columns; slices: K slices, a cluster of blocks along K summed through
    distributed shared memory in slice order; k_slice: the depth of each
    slice (the last one ragged)."""
    form: int
    bm: int
    bn: int
    slices: int
    k_slice: int


def _cut_k(K, want):
    """(slices, k_slice): at most `want` and MAX_SLICES slices, each at
    least MIN_SLICE deep (but one), k_slice a multiple of K_STEP, every
    slice nonempty."""
    most = max(1, min(want, MAX_SLICES, K // MIN_SLICE))
    per = -(-K // most)
    k_slice = max(K_STEP, -(-per // K_STEP) * K_STEP)
    return max(1, -(-K // k_slice)), k_slice


def mm_plan(M, N, K, gated=False, bf16=False):
    """The kernels' plan for x [M, K] @ w [K, N] (gated: matmul_swiglu's
    wg and wu; bf16: the bf16 form, which has the tiled form only), a
    pure function of the shape, so a shape always sums in one order.
    M <= 16 takes the skinny form: the widest column strip whose blocks,
    with K slices, reach two per SM.  Otherwise (and for bf16) the tiled
    form: of every tile and K cut, the one whose blocks take the least
    time, counted in whole waves of the clusters the card holds at once
    (CLUSTER_BLOCKS), a wave's time the tile's area x (k_slice + BLOCK_K)
    x blocks an SM / the tile's rate: a partial last wave costs a whole
    one, so the cut fills the card where the shape allows.  Ties go to
    the large tile and to fewer slices."""
    if min(M, N, K) < 0:
        raise build.KernelInputError("mm_plan: shape M %d, N %d, K %d"
                                     % (M, N, K))
    if M <= SKINNY_ROWS and not bf16:
        rows = 1 << max(0, M - 1).bit_length()
        for bn in SKINNY_COLS:
            strips = -(-N // bn)
            slices, k_slice = _cut_k(K, -(-2 * SMS // max(1, strips)))
            if strips * slices >= 2 * SMS:
                break
        return MmPlan(SKINNY, rows, bn, slices, k_slice)
    best = None
    for bm, bn, per_sm, rate in TILES[bool(gated)]:
        tiles = -(-M // bm) * -(-N // bn)
        for want in range(1, MAX_SLICES + 1):
            slices, k_slice = _cut_k(K, want)
            waves = -(-tiles // (CLUSTER_BLOCKS[per_sm][slices - 1] // slices))
            cost = waves * per_sm * bm * bn * (k_slice + BLOCK_K) * 100 / rate
            if best is None or cost < best[0]:
                best = (cost, MmPlan(TILED, bm, bn, slices, k_slice))
    return best[1]


def check_extent(name, M, N, K, plan):
    """Raise for shapes past the kernels' 32-bit indexing or grid."""
    tiles = -(-M // plan.bm) * -(-N // plan.bn)
    if max(M * K, K * N, M * N) >= 2 ** 31 or tiles > 65535:
        raise build.KernelInputError(
            "%s: [%d, %d] @ [%d, %d] exceeds the kernel's 32-bit indexing"
            % (name, M, K, K, N))


def mm_act(z, act):
    """float32 epilogue activation: exact-erf gelu and beta-1 swish, the
    same table as the reference's _mm_act."""
    if act in ("", "identity"):
        return z
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "tanh":
        return torch.tanh(z)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "gelu":
        return torch.nn.functional.gelu(z)
    if act == "swish":
        return z * torch.sigmoid(z)
    raise build.KernelInputError("matmul epilogue: unsupported activation %r"
                                 % (act,))


def matmul_bias_act_plain(x2d, w, bias=None, act=""):
    z = torch.matmul(x2d.float(), w.float())
    if bias is not None:
        z = z + bias.reshape(1, -1).float()
    return mm_act(z, act).to(x2d.dtype)


def mm_act_grad(z, act):
    """d act(z) / dz for the epilogue activations, in float32."""
    if act in ("", "identity"):
        return torch.ones_like(z)
    if act == "relu":
        # 0.5 at z == 0: the derivative of the reference's jnp.maximum,
        # which splits a tie between its two arguments
        return (z > 0).to(z.dtype) + 0.5 * (z == 0).to(z.dtype)
    if act == "tanh":
        return 1.0 - torch.tanh(z).square()
    if act == "sigmoid":
        s = torch.sigmoid(z)
        return s * (1.0 - s)
    if act == "gelu":
        return (0.5 * (1.0 + torch.erf(z * math.sqrt(0.5)))
                + z * torch.exp(-0.5 * z.square()) / math.sqrt(2.0 * math.pi))
    if act == "swish":
        s = torch.sigmoid(z)
        return s + z * s * (1.0 - s)
    raise build.KernelInputError("matmul epilogue: unsupported activation %r"
                                 % (act,))


def _mm_forward(x2d, w, bias, act):
    if not build.use_kernel(x2d):
        return matmul_bias_act_plain(x2d, w, bias, act)
    tensors = (x2d, w) if bias is None else (x2d, w, bias)
    build.check_inputs("matmul_bias_act", *tensors)
    bf16 = x2d.dtype == torch.bfloat16
    M, K = x2d.shape
    if w.dim() != 2 or w.shape[0] != K or (
            bias is not None and bias.numel() != w.shape[1]):
        raise build.KernelInputError("matmul_bias_act: shapes %s @ %s + %s" % (
            tuple(x2d.shape), tuple(w.shape),
            None if bias is None else tuple(bias.shape)))
    N = w.shape[1]
    plan = mm_plan(M, N, K, bf16=bf16)
    check_extent("matmul_bias_act", M, N, K, plan)
    out = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    build.launch("ptt_matmul_bias_act_bf16" if bf16 else "ptt_matmul_bias_act",
                 x2d, w, bias, out, M, N, K, _ACT_CODE[act], *plan)
    (matmul_bias_act_bf16 if bf16 else matmul_bias_act).launches += 1
    return out


class _MatmulBiasAct(torch.autograd.Function):
    @staticmethod
    def forward(x2d, w, bias, act):
        return _mm_forward(x2d, w, bias, act)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, w, bias, act = inputs
        ctx.save_for_backward(x2d, w, bias)
        ctx.act = act

    @staticmethod
    def backward(ctx, dy):
        x2d, w, bias = ctx.saved_tensors
        xf, wf = x2d.float(), w.float()
        z = torch.matmul(xf, wf)
        if bias is not None:
            z = z + bias.reshape(1, -1).float()
        dz = dy.float() * mm_act_grad(z, ctx.act)
        dx = torch.matmul(dz, wf.t()).to(x2d.dtype)
        dw = torch.matmul(xf.t(), dz).to(w.dtype)
        db = None if bias is None else dz.sum(0).to(bias.dtype)
        return dx, dw, db, None


def matmul_bias_act(x2d, w, bias=None, act=""):
    """act(x2d @ w + bias); act in MM_ACTS, bias [N] or None.
    Differentiable in x2d, w and bias (dense backward)."""
    if act not in _ACT_CODE:
        raise build.KernelInputError("matmul epilogue: unsupported activation "
                                     "%r" % (act,))
    return _MatmulBiasAct.apply(x2d, w, bias, act)


matmul_bias_act.launches = 0


# the bf16 form's launches count apart from the float32 form's
matmul_bias_act_bf16 = build.LaunchCount("matmul_bias_act_bf16")
