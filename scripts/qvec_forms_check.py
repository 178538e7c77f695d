#!/usr/bin/env python3
"""Times every split of flash_attention_qvec's forward (B8a,
paddle_tpu_torch/kernels/csrc/flash_attention_qvec.cu) that qvec_plan
can be asked for, and the SIMT form it replaced
(scripts/flash_attention_qvec_simt.cu, built here into a library of
its own), at the serving steps' shapes on the card, and prints the
plan's pick beside the fastest:

- GPT-2 small: q [96, 16, 64] over k/v [96, 1024, 64];
- TinyLlama widths: q [256, 16, 64] over k/v [256, 2048, 64];

each with every row's base at Tk - Tq (every key live), as chip_smoke's
_qvec_times, and with a pool's mixed bases (chip_smoke's slot bases:
0, mid-cache, Tk - Tq, a decode row, free slots), whose rows read from
a few keys to the whole cache.  The candidates: 2, 4 and 8 warps a block, slices of 256,
384, 512, 768 and 1024 keys, within the shared memory a block may have.

Each candidate is launched through build.launch with its own plan ints
(the wrapper takes qvec_plan's pick only) and is first held against
flash_attention_qvec_plain, 1e-5 absolute, with a rerun bit-equal, at
the serving shapes and at ragged edges (the 8 slot bases, Tk 300 and
2100 at d 128, Tk 40, Tq 20); the SIMT form is held the same way at the
serving shapes.  Times are chip_smoke's (CUDA graph replays, the median of 5),
in the order SIMT, pick, every candidate, pick, SIMT.  Prints ptxas's
registers and spills for both libraries.

    python3 scripts/qvec_forms_check.py
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HERE = os.path.dirname(os.path.abspath(__file__))
SIMT_SOURCE = os.path.join(HERE, "flash_attention_qvec_simt.cu")
SIMT_KV_CHUNK = 128  # the replaced form's fixed key slices
# (tag, BH, Tq, Tk, d, the slots' bases, or None for Tk - Tq in every row)
SHAPES = (("gpt2_serve", 96, 16, 1024, 64, None),
          ("llama_serve", 256, 16, 2048, 64, None),
          ("gpt2_pool", 96, 16, 1024, 64, [0, 500, 1008, 37, 0, 250, 999, 1]),
          ("llama_pool", 256, 16, 2048, 64,
           [0, 1000, 2032, 37, 0, 1500, 2000, 1]))
# (BH, Tq, Tk, d, bases a head row group): ragged edges
EDGES = ((16, 16, 1024, 64, [0, 500, 1008, 37, 0, 250, 999, 1]),
         (6, 4, 300, 128, [0, 130, 296]), (6, 4, 2100, 128, [0, 1100, 2096]),
         (4, 4, 40, 64, [3, 0]), (6, 20, 300, 64, [0, 150, 280]))


def candidates(tk, d):
    """Every distinct plan qvec_plan gives at Tk, d for the candidate
    warps and slice lengths, within the 232,448 bytes of shared memory
    a block may have (8 warps at d 128 are not)."""
    from paddle_tpu_torch.kernels.flash_attention import qvec_plan

    out = []
    for warps in (2, 4, 8):
        for slice_len in (256, 384, 512, 768, 1024):
            plan = qvec_plan(tk, d, warps, slice_len)
            if plan.smem <= 232448 and plan not in out:
                out.append(plan)
    return out


def qvec_launch(q, k, v, qs, plan):
    """o of the qvec kernel at `plan`."""
    import torch

    from paddle_tpu_torch.kernels import build

    bh, tq, d = q.shape
    tk = k.shape[1]
    o = torch.empty_like(q)
    parts = (None, None)
    if plan.slices > 1:
        parts = tuple(torch.empty(bh, tq, plan.slices, n, device=q.device)
                      for n in (d, 2))
    build.launch("ptt_flash_attention_qvec", q, k, v, qs, o, None, *parts,
                 bh, tq, tk, d, *plan, d ** -0.5)
    return o


def simt_lib():
    """The replaced SIMT form, built beside the kernel library (named by
    a hash of its source, the headers and the flags); its ptxas log is
    in simt_lib.log."""
    from paddle_tpu_torch.kernels import build

    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for path in (SIMT_SOURCE, os.path.join(build.CSRC, "common.cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    path = os.path.join(build.BUILD_DIR,
                        "libptt_qvec_simt_%s.so" % h.hexdigest()[:16])
    if not os.path.exists(path):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        tmp = path + ".tmp%d" % os.getpid()
        out = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
             "-shared", "-o", tmp, SIMT_SOURCE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        simt_lib.log = out.stdout
        if out.returncode != 0:
            raise RuntimeError("nvcc failed on the SIMT form:\n%s" % out.stdout)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ptt_qvec_simt.argtypes = [P] * 8 + [I] * 5 + [ctypes.c_float, P]
    lib.ptt_qvec_simt.restype = I
    return lib


simt_lib.log = ""


def simt_launch(lib, q, k, v, qs):
    """o of the replaced SIMT form (slices of SIMT_KV_CHUNK keys)."""
    import torch

    bh, tq, d = q.shape
    tk = k.shape[1]
    slices = -(-tk // SIMT_KV_CHUNK) if tk > SIMT_KV_CHUNK else 1
    o = torch.empty_like(q)
    parts = [None, None]
    if slices > 1:
        parts = [torch.empty(bh, tq, slices, n, device=q.device)
                 for n in (d, 2)]
    args = [t.data_ptr() if t is not None else None
            for t in (q, k, v, qs, o, None, *parts)]
    rc = lib.ptt_qvec_simt(*args, bh, tq, tk, d, SIMT_KV_CHUNK, d ** -0.5,
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("ptt_qvec_simt: CUDA error %d" % rc)
    return o


def ptxas_lines(log, names):
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(n in line for n in names)
        if keep and ("Compiling entry" in line or "registers" in line
                     or "spill" in line):
            out.append("  " + line.strip())
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("qvec_forms_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build, flash_attention_qvec_plain
    from paddle_tpu_torch.kernels.flash_attention import qvec_plan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    log = build.build_log[build.build_log.find("== flash_attention_qvec.cu"):]
    print("\n".join(ptxas_lines(log.split("\n== ")[0], ("qvec",))))
    lib = simt_lib()
    print("\n".join(ptxas_lines(simt_lib.log, ("qvec",))), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def held(fn, q, k, v, qs, what):
        want = flash_attention_qvec_plain(q, k, v, qs, q.shape[-1] ** -0.5)
        got = fn()
        err = (got - want).abs().max().item()
        assert err <= 1e-5, (what, "disagrees", err)
        assert torch.equal(got, fn()), (what, "rerun differs")
        return err

    worst = 0.0
    for bh, tq, tk, d, bases in EDGES:
        q, k, v = randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d)
        qs = torch.tensor(bases, device=dev, dtype=torch.int32
                          ).repeat_interleave(bh // len(bases))
        for plan in candidates(tk, d):
            worst = max(worst, held(lambda: qvec_launch(q, k, v, qs, plan),
                                    q, k, v, qs, (bh, tq, tk, d, plan)))
    print("edges held: worst error %.3g" % worst, flush=True)
    for tag, bh, tq, tk, d, bases in SHAPES:
        q, k, v = randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d)
        qs = torch.full((bh,), tk - tq, device=dev, dtype=torch.int32)
        if bases is not None:
            qs = torch.tensor(bases, device=dev, dtype=torch.int32
                              ).repeat_interleave(bh // len(bases))
        plans = candidates(tk, d)
        for plan in plans:
            worst = max(worst, held(lambda: qvec_launch(q, k, v, qs, plan),
                                    q, k, v, qs, (tag, plan)))
        simt_err = held(lambda: simt_launch(lib, q, k, v, qs), q, k, v, qs,
                        (tag, "simt"))
        pick = qvec_plan(tk, d)
        key = lambda p: "w%d/len%d" % p[:2]  # noqa: E731
        simt = [cs._time_ms(lambda: simt_launch(lib, q, k, v, qs))]
        picked = [cs._time_ms(lambda: qvec_launch(q, k, v, qs, pick))]
        row = {key(p): cs._time_ms(lambda: qvec_launch(q, k, v, qs, p))
               for p in plans}
        picked.append(cs._time_ms(lambda: qvec_launch(q, k, v, qs, pick)))
        simt.append(cs._time_ms(lambda: simt_launch(lib, q, k, v, qs)))
        live = int(torch.clamp(qs + tq, max=tk).sum())  # keys read
        bound, _ = cs._bound_ms(4 * (2 * bh * tq * d + 2 * live * d)
                                + 4 * bh, 4 * tq * live * d)
        best = min(row, key=row.get)
        print("B8a %s q [%d, %d, %d] k/v [%d, %d, %d]: pick %s %s, fastest "
              "%s %.6f, SIMT %s (err %.2g), bound %.6f (bytes); %s" % (
                  tag, bh, tq, d, bh, tk, d, key(pick),
                  " / ".join("%.6f" % t for t in picked), best, row[best],
                  " / ".join("%.6f" % t for t in simt), simt_err, bound,
                  json.dumps(row)), flush=True)
    print("every split held against its plain version: worst error %.3g"
          % worst, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
