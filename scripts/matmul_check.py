#!/usr/bin/env python3
"""A short on-card check of matmul_bias_act (B5) and matmul_swiglu (B6),
csrc/matmul_bias_act.cu: builds the kernel library, prints ptxas's
register, shared-memory and spill lines for its kernels, holds both
against their plain versions at the plan's edges (skinny M 1-16, tiled
M 17+, K slices, K 1000, N 2 and 333, every activation, with and
without bias) with a bit-equal rerun, then times both at the paths'
shapes beside the plain version and the library call (addmm + act; two
matmuls + silu(g) * u), with each shape's bounds: bytes / 3.35 TB/s,
FLOPs / 67 TFLOP/s (FP32) and FLOPs / 165 TFLOP/s (3xTF32).

    python3 scripts/matmul_check.py [--times-only] [--plans] [--card]
                                    [--root DIR] [--timeout S]

--root DIR imports paddle_tpu_torch from another checkout (an older tree
unpacked under build/, whose kernels build under its own build/), so
one call can time two trees in turns: older, newer, newer, older.
--times-only skips the edge checks (an older tree may not take them).
--plans times every tiled plan mm_plan weighs (both tiles, 1-8 K slices)
at the paths' shapes and prints mm_plan's pick beside the fastest: the
check of the plan's cost model (matmul_epilogue.TILES' rates, BLOCK_K).
--card measures what the model and the kernels' notes take from the
card: mma.sync.m16n8k8's TF32 rate (16 independent accumulators a warp,
registers only) and, from cudaOccupancyMaxActiveClusters, the blocks the
card holds at once in clusters of 1-8 with one or two blocks an SM
(matmul_epilogue.CLUSTER_BLOCKS).
The work runs in a child process, killed after --timeout seconds
(default 600), so a kernel that never returns ends the call.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32X3_FLOPS_PER_S = 495e12 / 3
ACTS = ("", "relu", "tanh", "sigmoid", "gelu", "swish")
# (M, K, N): the plan's edges
B5_EDGES = ((1, 768, 3072), (2, 5632, 2048), (4, 768, 3072), (4, 3072, 768),
            (8, 3072, 768), (16, 768, 3072), (17, 768, 3072), (3, 100, 70),
            (16, 1000, 333), (37, 1000, 70), (45, 1600, 90), (32, 768, 2),
            (128, 3072, 768), (128, 768, 3072), (200, 1000, 333),
            (4096, 2048, 512), (256, 5632, 2048), (0, 64, 64), (5, 0, 7))
B6_EDGES = ((1, 2048, 5632), (2, 2048, 5632), (2, 2048, 333), (16, 100, 70),
            (17, 2048, 5632), (128, 2048, 5632), (200, 1000, 333),
            (21, 19, 15), (256, 2048, 5632))
# (tag, M, K, N, act): the paths' shapes
B5_PATHS = (("serve_ffn_in", 128, 768, 3072, "gelu"),
            ("serve_ffn_out", 128, 3072, 768, ""),
            ("wmt_ffn_in", 4096, 512, 2048, "relu"),
            ("wmt_ffn_out", 4096, 2048, 512, ""),
            ("gpt2_ffn_in", 8192, 768, 3072, "gelu"),
            ("gpt2_ffn_out", 8192, 3072, 768, ""),
            ("llama_ffn_out", 4096, 5632, 2048, ""),
            ("llama_serve_ffn_out", 128, 5632, 2048, ""),
            ("bert_ffn_in", 4096, 768, 3072, "relu"),
            ("bert_ffn_out", 4096, 3072, 768, ""),
            ("bert_mlm_trans", 4096, 768, 768, "gelu"),
            ("gpt2_decode_ffn_in", 4, 768, 3072, "gelu"),
            ("gpt2_decode_ffn_out", 4, 3072, 768, ""),
            ("gpt2_beam_ffn_in", 8, 768, 3072, "gelu"),
            ("gpt2_prefill_ffn_in", 256, 768, 3072, "gelu"),
            ("gpt2_prefill_ffn_out", 256, 3072, 768, ""),
            ("llama_decode_ffn_out", 2, 5632, 2048, ""),
            ("llama_prefill_ffn_out", 256, 5632, 2048, ""))
B6_PATHS = (("train", 4096, 2048, 5632), ("serve", 128, 2048, 5632),
            ("decode", 2, 2048, 5632), ("prefill", 256, 2048, 5632))


def bounds(nbytes, flops):
    """(bytes bound, FP32 bound, 3xTF32 bound) in ms."""
    return (nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3,
            flops / TF32X3_FLOPS_PER_S * 1e3)


def time_ms(fn, inner):
    """Device ms of one call: `inner` calls captured in a CUDA graph, the
    median of 5 replays timed with CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[2]


def check_edges(dev, randn):
    import torch

    from paddle_tpu_torch.kernels import (matmul_bias_act,
                                          matmul_bias_act_plain,
                                          matmul_swiglu, matmul_swiglu_plain)
    from paddle_tpu_torch.kernels.matmul_epilogue import mm_plan

    worst5 = worst6 = 0.0
    for m, k, n in B5_EDGES:
        x, w, b = randn(m, k), randn(k, n, scale=max(k, 1) ** -0.5), randn(n)
        err = 0.0
        same = True
        for act in ACTS:
            for bias in (b, None):
                out = matmul_bias_act(x, w, bias, act)
                torch.cuda.synchronize()
                ref = matmul_bias_act_plain(x, w, bias, act)
                if out.numel():
                    err = max(err, (out - ref).abs().max().item())
                same &= torch.equal(out, matmul_bias_act(x, w, bias, act))
        worst5 = max(worst5, err)
        print("matmul_bias_act [%d, %d] @ [%d, %d] plan %s: max abs err %.3g, "
              "rerun bit-equal %s" % (m, k, k, n, tuple(mm_plan(m, n, k)), err,
                                      same), flush=True)
        assert same, "matmul_bias_act rerun differs"
    for m, k, n in B6_EDGES:
        x = randn(m, k)
        wg, wu = randn(k, n, scale=k ** -0.5), randn(k, n, scale=k ** -0.5)
        out = matmul_swiglu(x, wg, wu)
        torch.cuda.synchronize()
        ref = matmul_swiglu_plain(x, wg, wu)
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        same = torch.equal(out, matmul_swiglu(x, wg, wu))
        worst6 = max(worst6, err)
        print("matmul_swiglu [%d, %d] @ [%d, %d] plan %s: max rel err %.3g, "
              "rerun bit-equal %s" % (m, k, k, n, tuple(mm_plan(m, n, k, True)),
                                      err, same), flush=True)
        assert same, "matmul_swiglu rerun differs"
    print("worst: matmul_bias_act %.3g abs, matmul_swiglu %.3g rel"
          % (worst5, worst6), flush=True)
    assert worst5 <= 1e-4 and worst6 <= 1e-4, (worst5, worst6)


def times(dev, randn):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (matmul_bias_act,
                                          matmul_bias_act_plain,
                                          matmul_swiglu, matmul_swiglu_plain)

    for tag, m, k, n, act in B5_PATHS:
        x, w, b = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n)
        act_fn = {"gelu": F.gelu, "relu": F.relu}.get(act)
        lib = ((lambda: act_fn(torch.addmm(b, x, w))) if act
               else (lambda: torch.addmm(b, x, w)))
        inner = 5 if m * k * n > 2e10 else 20
        by, fp32, tf32x3 = bounds(4 * (m * k + k * n + n + m * n),
                                  2 * m * k * n)
        rec = dict(ms=time_ms(lambda: matmul_bias_act(x, w, b, act), inner),
                   plain_ms=time_ms(lambda: matmul_bias_act_plain(x, w, b, act),
                                    inner),
                   library_ms=time_ms(lib, inner), bytes_ms=by, fp32_ms=fp32,
                   tf32x3_ms=tf32x3)
        print("B5 %s [%d, %d] @ [%d, %d] %s: %s" % (
            tag, m, k, k, n, act or "identity", json.dumps(rec)), flush=True)
    for tag, m, k, n in B6_PATHS:
        x = randn(m, k)
        wg, wu = randn(k, n, scale=k ** -0.5), randn(k, n, scale=k ** -0.5)
        inner = 5 if tag == "train" else 20
        by, fp32, tf32x3 = bounds(4 * (m * k + 2 * k * n + m * n),
                                  4 * m * k * n)
        rec = dict(ms=time_ms(lambda: matmul_swiglu(x, wg, wu), inner),
                   plain_ms=time_ms(lambda: matmul_swiglu_plain(x, wg, wu),
                                    inner),
                   library_ms=time_ms(lambda: F.silu(torch.matmul(x, wg))
                                      * torch.matmul(x, wu), inner),
                   bytes_ms=by, fp32_ms=fp32, tf32x3_ms=tf32x3)
        print("B6 %s [%d, %d] @ [%d, %d]: %s" % (tag, m, k, k, n,
                                                 json.dumps(rec)), flush=True)


CARD_CU = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void hmma(float* out, int iters) {
  float d[16][4] = {};
  unsigned a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  unsigned b0 = a0 * 3, b1 = a0 * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void idle(float* p) {
  extern __shared__ float s[];
  if (p) p[threadIdx.x] = s[threadIdx.x];
}
int main() {
  float* out;
  cudaMalloc(&out, 528 * 512 * sizeof(float));
  int blocks[] = {132, 264, 528}, iters = 2000;
  for (int b : blocks) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    hmma<<<b, 256>>>(out, iters);
    cudaEventRecord(e0);
    hmma<<<b, 256>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double flops = 2048.0 * 16 * iters * (b * 256 / 32);
    printf("mma.sync tf32 m16n8k8, %d blocks of 8 warps: %.1f TFLOP/s TF32 "
           "(%.1f as 3xTF32)\n", b, flops / ms / 1e9, flops / ms / 3e9);
  }
  cudaFuncSetAttribute(idle, cudaFuncAttributeMaxDynamicSharedMemorySize, 131072);
  for (int per_sm = 1; per_sm <= 2; ++per_sm) {
    printf("blocks held at once, %d block(s) an SM, clusters of 1..8:", per_sm);
    for (int c = 1; c <= 8; ++c) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c, 1024);
      cfg.blockDim = dim3(256);
      cfg.dynamicSmemBytes = per_sm == 1 ? 131072 : 98304;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, idle, &cfg) != cudaSuccess) n = -1;
      printf(" %d", n * c);
    }
    printf("\n");
  }
  return 0;
}
"""


def card(root):
    """mma.sync's TF32 rate and the card's cluster capacities."""
    from paddle_tpu_torch.kernels import build

    out = os.path.join(root, "build", "matmul_check")
    os.makedirs(out, exist_ok=True)
    src, exe = os.path.join(out, "card.cu"), os.path.join(out, "card")
    with open(src, "w") as f:
        f.write(CARD_CU)
    subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-o", exe, src], check=True)
    subprocess.run([exe], check=True)


def plans(dev, randn):
    """Every tiled plan mm_plan weighs, timed at the paths' shapes."""
    import torch

    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import matmul_epilogue as me

    def candidates(m, n, k, gated):
        seen = []
        for bm, bn, _, _ in me.TILES[gated]:
            for want in range(1, me.MAX_SLICES + 1):
                p = me.MmPlan(me.TILED, bm, bn, *me._cut_k(k, want))
                if p not in seen:
                    seen.append(p)
        return seen

    acts = {"": 0, "relu": 1, "gelu": 4}
    shapes = [(tag, m, k, n, act, False) for tag, m, k, n, act in B5_PATHS
              if m > 16] + [(tag, m, k, n, "", True) for tag, m, k, n in B6_PATHS
                            if m > 16]
    for tag, m, k, n, act, gated in shapes:
        x = randn(m, k)
        w, wu, b = randn(k, n, scale=k ** -0.5), randn(k, n, scale=k ** -0.5), randn(n)
        out = torch.empty(m, n, device=dev)
        row = {}
        for p in candidates(m, n, k, gated):
            if gated:
                fn = lambda: build.launch("ptt_matmul_swiglu", x, w, wu, out, m, n, k, *p)
            else:
                fn = lambda: build.launch("ptt_matmul_bias_act", x, w, b, out, m, n, k,
                                          acts[act], *p)
            row["%d/%d/%d" % (p.bm, p.bn, p.slices)] = round(
                time_ms(fn, 5 if m * k * n > 2e10 else 20), 5)
        pick = me.mm_plan(m, n, k, gated)
        key = "%d/%d/%d" % (pick.bm, pick.bn, pick.slices)
        best = min(row, key=row.get)
        print("%s %s [%d, %d] @ [%d, %d]: pick %s %.5f, fastest %s %.5f; %s" % (
            "B6" if gated else "B5", tag, m, k, k, n, key, row[key], best,
            row[best], json.dumps(row)), flush=True)


def child(root, times_only, want_plans, want_card):
    sys.path.insert(0, root)
    import torch

    from paddle_tpu_torch.kernels import build

    print("tree %s" % root, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.load()
    print("built in %.1f s" % (time.time() - t0), flush=True)
    log = build.build_log
    part = log[log.find("== matmul_bias_act.cu"):].split("\n== ")[0]
    for line in part.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    if want_card:
        card(root)
    if not times_only:
        check_edges(dev, randn)
    times(dev, randn)
    if want_plans:
        plans(dev, randn)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("matmul_check: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    root = ROOT
    if "--root" in args:
        root = os.path.abspath(args[args.index("--root") + 1])
    if "--child" in args:
        return child(root, "--times-only" in args, "--plans" in args,
                     "--card" in args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    timeout = 600
    if "--timeout" in args:
        timeout = int(args[args.index("--timeout") + 1])
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--root",
           root] + [a for a in args if a in ("--times-only", "--plans",
                                             "--card")]
    try:
        return subprocess.run(cmd, timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        print("matmul_check: the check did not end within %d s" % timeout,
              file=sys.stderr)
        return 124


if __name__ == "__main__":
    sys.exit(main())
