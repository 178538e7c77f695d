"""Build, load and launch the hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface.  At first
use, every source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared
library under ``build/paddle_tpu_torch/`` beside the package, named by a
hash of the sources and flags so an edited source rebuilds.  The
library is loaded with ``ctypes`` and every entry point's argument types
are declared (``SIGNATURES``): pointers and the stream pass as
``c_void_p``, so none is cut to 32 bits.  Each C entry point returns
``cudaGetLastError()`` after its launch and ``launch`` raises on a
nonzero code: a refused launch never runs, and a synchronize would not
report it.

A missing ``nvcc``, a failed compile, load or launch raises KernelError
(a RuntimeError), and a kernel that refuses its inputs raises
KernelInputError or KernelTypeError (KernelErrors that are also a
ValueError or a TypeError); nothing falls back to a plain path for a
CUDA tensor.
Nothing here runs at import, so the package imports on a machine with
no CUDA toolchain.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = ["load", "build", "use_kernel", "check_inputs", "launch",
           "BUILD_DIR", "BF16_FORMS", "BF16_QUEUED", "KV_BF16_FORMS",
           "kv_bf16", "LaunchCount",
           "KernelError", "KernelInputError", "KernelTypeError"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "paddle_tpu_torch")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the toolkit's standard location
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each C entry point's argument types, in order; the stream is last
SIGNATURES = {
    # R, H, then the plan's four (n4, vec, warps, rows:
    # add_layer_norm.add_ln_plan)
    "ptt_add_layer_norm": (_P,) * 8 + (_I,) * 6 + (_F, _P),
    "ptt_add_layer_norm_bf16": (_P,) * 8 + (_I,) * 6 + (_F, _P),
    # the shape ints (and the activation), then the plan's five (form,
    # bm, bn, slices, k_slice: matmul_epilogue.mm_plan)
    "ptt_matmul_bias_act": (_P,) * 4 + (_I,) * 9 + (_P,),
    "ptt_matmul_bias_act_bf16": (_P,) * 4 + (_I,) * 9 + (_P,),
    "ptt_matmul_swiglu": (_P,) * 4 + (_I,) * 8 + (_P,),
    "ptt_matmul_swiglu_bf16": (_P,) * 4 + (_I,) * 8 + (_P,),
    # BH, Tq, Tk, d, then the plan's four (warps, slice_len, slices,
    # smem: flash_attention.qvec_plan)
    "ptt_flash_attention_qvec": (_P,) * 8 + (_I,) * 8 + (_F, _P),
    "ptt_flash_attention_qvec_kvbf16": (_P,) * 8 + (_I,) * 8 + (_F, _P),
    # BH, Tq, Tk, d, then the plan's two (slice_len, slices:
    # flash_attention.rows_plan)
    "ptt_flash_attention_rows": (_P,) * 8 + (_I,) * 6 + (_F, _P),
    "ptt_flash_attention_rows_kvbf16": (_P,) * 8 + (_I,) * 6 + (_F, _P),
    # the linear cross entropy's shape ints, then its plan's four (hs, n,
    # stages, smem: linear_xent.lxent_plan)
    "ptt_linear_xent_fwd": (_P,) * 6 + (_I,) * 8 + (_F, _P),
    "ptt_linear_xent_dx": (_P,) * 6 + (_I,) * 7 + (_F, _P),
    "ptt_linear_xent_dw": (_P,) * 6 + (_I,) * 7 + (_F, _P),
    "ptt_linear_xent_parts": (_P,) * 7 + (_I,) * 8 + (_P,),
    # the bf16 forms: R, H, V (the forward: and its split count), eps
    # (linear_xent_bf16.cu; no plan)
    "ptt_linear_xent_fwd_bf16": (_P,) * 6 + (_I,) * 4 + (_F, _P),
    "ptt_linear_xent_dx_bf16": (_P,) * 6 + (_I,) * 3 + (_F, _P),
    "ptt_linear_xent_dw_bf16": (_P,) * 6 + (_I,) * 3 + (_F, _P),
    "ptt_linear_xent_dx_sharded": (_P,) * 7 + (_I,) * 8 + (_F, _P),
    "ptt_linear_xent_dw_sharded": (_P,) * 7 + (_I,) * 8 + (_F, _P),
    # B12's bf16 forms: R, H, V (parts: and its split count; dx / dw: and
    # vocab_total), eps (linear_xent_bf16.cu; no plan)
    "ptt_linear_xent_parts_bf16": (_P,) * 7 + (_I,) * 4 + (_P,),
    "ptt_linear_xent_dx_sharded_bf16": (_P,) * 7 + (_I,) * 4 + (_F, _P),
    "ptt_linear_xent_dw_sharded_bf16": (_P,) * 7 + (_I,) * 4 + (_F, _P),
    # R, H, then the plan's four (form, n4, vec, rows: layer_norm.ln_plan)
    "ptt_layer_norm": (_P,) * 6 + (_I,) * 6 + (_F, _P),
    "ptt_layer_norm_bf16": (_P,) * 6 + (_I,) * 6 + (_F, _P),
    # BH, Tq, Tk, d, then the plan's form (flash_attention.flash_plan),
    # then the mask: causal, qstride, scale, window, segment ids
    "ptt_flash_attention_fwd": (_P,) * 7 + (_I,) * 7 + (_F, _I, _P, _P),
    "ptt_flash_attention_dq": (_P,) * 9 + (_I,) * 7 + (_F, _I, _P, _P),
    "ptt_flash_attention_dkv": (_P,) * 11 + (_I,) * 7 + (_F, _I, _P, _P),
    "ptt_flash_attention_fwd_bf16": (_P,) * 7 + (_I,) * 7 + (_F, _I, _P, _P),
    "ptt_flash_attention_fwd_kvbf16": (_P,) * 7 + (_I,) * 7 + (_F, _I, _P, _P),
    "ptt_flash_attention_dq_bf16": (_P,) * 9 + (_I,) * 7 + (_F, _I, _P, _P),
    "ptt_flash_attention_dkv_bf16": (_P,) * 11 + (_I,) * 7 + (_F, _I, _P, _P),
    # the plan's four (form, ctas, threads, smem: softmax_xent.sxent_plan),
    # then R, C
    "ptt_softmax_xent_fwd": (_P,) * 3 + (_I,) * 6 + (_P,),
    "ptt_softmax_xent_bwd": (_P,) * 4 + (_I,) * 6 + (_P,),
    # B, T, H, then the plan's seven (units, k_warps, n_warps, k_steps,
    # rows, regs, smem: recurrent.rnn_plan)
    "ptt_lstm_seq": (_P,) * 9 + (_I,) * 10 + (_P,),
    "ptt_gru_seq": (_P,) * 7 + (_I,) * 10 + (_P,),
}

_lib = None
_lock = threading.Lock()
build_log = ""  # nvcc/ptxas output of the last build (registers, spills)


class KernelError(RuntimeError):
    """A kernel that cannot build, load or launch, or that refuses its
    inputs.  Callers that recover from other errors (the serving
    fabric's failover) let this one end the run."""


class KernelInputError(KernelError, ValueError):
    """A kernel that refuses its inputs' shapes, extents, alignment or
    devices: a ValueError, and a KernelError all the same."""


class KernelTypeError(KernelError, TypeError):
    """A kernel that refuses its inputs' dtype: a TypeError, and a
    KernelError all the same."""


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def nvcc_path():
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise KernelError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of paddle_tpu_torch cannot be built, and a CUDA tensor has "
        "no other path")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, path), "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build():
    """Compile csrc/*.cu into the shared library (if not built yet);
    returns its path.  Raises with nvcc's output on failure."""
    global build_log
    lib_path = os.path.join(BUILD_DIR, "libptt_kernels_%s.so" % _digest())
    if os.path.exists(lib_path):
        return lib_path
    nvcc = nvcc_path()
    obj_dir = os.path.join(BUILD_DIR, "obj_%d" % os.getpid())
    os.makedirs(obj_dir, exist_ok=True)
    procs = []
    for src in sources():
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append("== %s\n%s" % (os.path.basename(src), out))
        if p.returncode != 0:
            failed.append(logs[-1])
    build_log = "\n".join(logs)
    if failed:
        raise KernelError("nvcc failed:\n%s" % "\n".join(failed))
    tmp = lib_path + ".tmp%d" % os.getpid()
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         tmp] + [obj for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelError("linking the kernel library failed:\n%s"
                          % link.stdout)
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


def load():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError("loading %s failed: %s" % (path, e)) from e
            lib.ptt_error_string.restype = ctypes.c_char_p
            lib.ptt_error_string.argtypes = [_I]
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = _I
            _lib = lib
    return _lib


def use_kernel(t):
    """The one dispatch rule of every kernel wrapper: CPU tensors take
    the plain PyTorch version, and so do meta tensors (build-time shape
    inference); CUDA tensors launch the kernel; any other device
    raises."""
    kind = t.device.type
    if kind in ("cpu", "meta"):
        return False
    if kind == "cuda":
        return True
    raise KernelError("no kernel and no plain path for device %s" % t.device)


class LaunchCount:
    """The launch count of a kernel's bf16 form, which the kernel's
    wrapper keeps apart from its float32 form's: ``__name__`` and
    ``launches`` as a wrapper in ``kernels.KERNELS`` has them."""

    def __init__(self, name):
        self.__name__ = name
        self.launches = 0


# the per-kernel dtype rule: the kernels with a bf16 form, each with the
# positions of its check_inputs operands that stay float32 whatever the
# working dtype (B1 and B2's gamma and beta, which the AMP trunk pass
# keeps float32; B4's saved lse and dy; B12's row validity, lse and dy;
# B3's lse and delta and its key bias, which check_inputs sees after the
# rows: position 3 in the forward, 6 in dq and dk/dv)
BF16_FORMS = {"matmul_bias_act": (), "fused_layer_norm": (1, 2),
              "fused_add_layer_norm": (2, 3), "linear_xent_fwd": (),
              "linear_xent_dx": (2, 3), "linear_xent_dw": (2, 3),
              "linear_xent_parts": (), "linear_xent_dx_sharded": (2, 3, 4),
              "linear_xent_dw_sharded": (2, 3, 4),
              "matmul_swiglu": (), "flash_attention_fwd": (3,),
              "flash_attention_dq": (3, 5, 6),
              "flash_attention_dkv": (3, 5, 6)}
# the bf16-KV forms: the kernels that read a bf16 KV cache (B3's few-row
# form, B9's forward, B8's forward) take float32 q with bf16 k and v, the
# operands at these positions of check_inputs; their o, lse and key bias
# stay float32
KV_BF16_FORMS = {"flash_attention_fwd_rows": (1, 2),
                 "flash_attention_piece_fwd": (1, 2),
                 "flash_attention_qvec": (1, 2)}
# where the bf16 forms of the other kernels are queued in ROADMAP: a bf16
# q to the KV-cache readers, and bf16 k / v to their backwards, B8q; the
# rest wait in queue B
_KV = "B8q, the bf16-q forms of the KV-cache readers and their backwards"
BF16_QUEUED = {n: _KV for n in (
    "flash_attention_fwd_rows", "flash_attention_piece_fwd",
    "flash_attention_piece_dq", "flash_attention_piece_dkv",
    "flash_attention_qvec", "flash_attention_qvec_dq",
    "flash_attention_qvec_dkv")}


def kv_bf16(name, *tensors):
    """Whether a call takes kernel `name`'s bf16-KV form: a float32 q (the
    first tensor) with a bf16 k (the second), for the KV-cache readers
    (``KV_BF16_FORMS``)."""
    return (name in KV_BF16_FORMS and len(tensors) > 1
            and tensors[0].dtype == torch.float32
            and tensors[1].dtype == torch.bfloat16)


def check_inputs(name, *tensors):
    """What every kernel takes: contiguous tensors on one CUDA device, of
    the kernel's working dtype, which is the first tensor's: float32, or
    bfloat16 for the kernels with a bf16 form (``BF16_FORMS``, whose
    float32 operands stay float32 in both forms).  The KV-cache readers
    (``KV_BF16_FORMS``) also take a float32 q with bf16 k and v, their
    bf16-KV form.  Any other dtype raises KernelTypeError: there is no
    fallback to the plain version.  Whether autograd is on decides
    nothing here: the kernels' wrappers are ``torch.autograd.Function``s,
    whose backward is a kernel or a dense recompute."""
    dev = tensors[0].device
    work = tensors[0].dtype
    kv16 = kv_bf16(name, *tensors)
    if (work != torch.float32 and not (work == torch.bfloat16
                                       and name in BF16_FORMS)) or (
            name in BF16_QUEUED and not kv16
            and any(t.dtype == torch.bfloat16 for t in tensors)):
        raise KernelTypeError(
            "%s: the CUDA kernel takes float32%s, got %s (its bf16 form is "
            "queued in ROADMAP B, the bf16 forms%s)" % (
                name, " q" if name in KV_BF16_FORMS else "",
                "/".join(sorted({str(t.dtype) for t in tensors})),
                ": " + BF16_QUEUED[name] if name in BF16_QUEUED else ""))
    f32 = BF16_FORMS.get(name, ())
    bf = KV_BF16_FORMS[name] if kv16 else ()
    for i, t in enumerate(tensors):
        want = (torch.bfloat16 if i in bf
                else torch.float32 if i in f32 else work)
        if t.dtype != want:
            raise KernelTypeError("%s: the CUDA kernel's operand %d must be %s "
                                  "with %s inputs, got %s"
                                  % (name, i, want, work, t.dtype))
        if t.device != dev:
            raise KernelInputError("%s: inputs on %s and %s"
                                   % (name, dev, t.device))
        if not t.is_contiguous():
            raise KernelInputError("%s: the CUDA kernel takes contiguous "
                                   "tensors" % name)


def launch(fn_name, *args):
    """Call C entry point `fn_name` (declared in SIGNATURES) with tensors
    as device pointers and None as a null pointer, on the current stream;
    raise on a nonzero CUDA error code."""
    lib = load()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    cargs.append(torch.cuda.current_stream().cuda_stream)
    rc = getattr(lib, fn_name)(*cargs)
    if rc != 0:
        raise KernelError("%s: CUDA error %d (%s)" % (
            fn_name, rc, lib.ptt_error_string(rc).decode()))
