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
"""

import math

import torch

from . import build

__all__ = ["matmul_bias_act", "matmul_bias_act_plain", "mm_act", "MM_ACTS"]

# the epilogue activations, in the kernel's enum order ("" is identity)
MM_ACTS = ("", "identity", "relu", "tanh", "sigmoid", "gelu", "swish")
_ACT_CODE = {"": 0, "identity": 0, "relu": 1, "tanh": 2, "sigmoid": 3,
             "gelu": 4, "swish": 5}
# the kernel's fixed split-K: K is cut into slices of this many (a
# multiple of the kernel's 16-deep k step), summed in slice order
K_SLICE = 768


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
    raise ValueError("matmul epilogue: unsupported activation %r" % (act,))


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
    raise ValueError("matmul epilogue: unsupported activation %r" % (act,))


def _mm_forward(x2d, w, bias, act):
    if not build.use_kernel(x2d):
        return matmul_bias_act_plain(x2d, w, bias, act)
    tensors = (x2d, w) if bias is None else (x2d, w, bias)
    build.check_inputs("matmul_bias_act", *tensors)
    M, K = x2d.shape
    if w.dim() != 2 or w.shape[0] != K or (
            bias is not None and bias.numel() != w.shape[1]):
        raise ValueError("matmul_bias_act: shapes %s @ %s + %s" % (
            tuple(x2d.shape), tuple(w.shape),
            None if bias is None else tuple(bias.shape)))
    N = w.shape[1]
    if max(M * K, K * N, -(-K // K_SLICE) * M * N) >= 2 ** 31 or (
            M > 32 * 65535):
        raise ValueError("matmul_bias_act: [%d, %d] @ [%d, %d] exceeds the "
                         "kernel's 32-bit indexing" % (M, K, K, N))
    out = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    slices = -(-K // K_SLICE)
    workspace = (torch.empty((slices, M, N), dtype=torch.float32,
                             device=x2d.device) if slices > 1 else None)
    build.launch("ptt_matmul_bias_act", x2d, w, bias, out, workspace, M, N,
                 K, K_SLICE, _ACT_CODE[act])
    matmul_bias_act.launches += 1
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
        raise ValueError("matmul epilogue: unsupported activation %r" % (act,))
    return _MatmulBiasAct.apply(x2d, w, bias, act)


matmul_bias_act.launches = 0
