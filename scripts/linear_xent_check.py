#!/usr/bin/env python3
"""A short on-card check of the linear cross-entropy kernels
(csrc/linear_xent.cu: B4's forward, dx and dw, B12's parts, dx and dw):
builds the kernel library, prints ptxas's register, shared-memory and
spill lines for them, holds each against its plain version at the plan's
edges (H 600, 776, 2050, 4096, 6400; R 8191; odd V) with a bit-equal
rerun, and times forward, dx and dw beside matmul + cross_entropy at the
training paths' shapes (GPT-2, TinyLlama widths, BERT's MLM head, WMT).
With --full it then runs chip_smoke.py's check_linear_xent and
check_sharded_linear_xent (every path shape, timed).

    python3 scripts/linear_xent_check.py [--full]   # one CUDA card, nvcc

The checks run in a child process, killed after --timeout seconds
(default 600), so a kernel that never returns ends the call instead of
holding the card.  The quick first call for a change to
csrc/linear_xent.cu before a full chip_smoke.py run.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (R, H, V, eps): the plan's edges, small R and V
EDGES = ((100, 512, 1007, 0.1), (70, 600, 300, 0.1), (300, 776, 1001, 0.1),
         (100, 2050, 999, 0.1), (200, 4096, 515, 0.0), (8191, 512, 777, 0.1),
         (256, 768, 4000, 0.0), (64, 8, 64, 0.1), (64, 6400, 300, 0.1))
# (tag, R, H, V): the training paths' heads
PATHS = (("gpt2", 8192, 768, 50257), ("llama", 4096, 2048, 32000),
         ("bert", 4096, 768, 30522), ("wmt", 4096, 512, 10000))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def child(full):
    import importlib

    import torch
    import torch.nn.functional as F

    import chip_smoke
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import linear_xent as lx

    # the module, not the package's function of the same name
    slx = importlib.import_module("paddle_tpu_torch.kernels.sharded_linear_xent")

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.load()
    print("built in %.1f s" % (time.time() - t0), flush=True)
    chip_smoke._print_ptxas("linear_xent.cu", ("lxent",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    worst = 0.0
    for r, h, v, eps in EDGES:
        x, w = randn(r, h), randn(h, v, scale=h ** -0.5)
        lbl = torch.randint(0, v, (r,), generator=g, device=dev)
        lbl[0], lbl[1] = -1, v
        dy = torch.rand(r, 1, generator=g, device=dev)
        loss, lse = lx.linear_xent_fwd(x, w, lbl, eps)
        torch.cuda.synchronize()
        p_loss, p_lse = lx.linear_xent_plain(x, w, lbl, eps)
        dx = lx.linear_xent_dx(x, w, lbl, lse, dy, eps)
        dw = lx.linear_xent_dw(x, w, lbl, lse, dy, eps)
        torch.cuda.synchronize()
        p_dx, p_dw = lx.linear_xent_grad_plain(x, w, lbl, p_lse, dy, eps)
        same = (torch.equal(loss, lx.linear_xent_fwd(x, w, lbl, eps)[0])
                and torch.equal(dx, lx.linear_xent_dx(x, w, lbl, lse, dy, eps))
                and torch.equal(dw, lx.linear_xent_dw(x, w, lbl, lse, dy, eps)))
        vt, shard = 3 * v, 1
        lbl_g = torch.randint(0, vt, (r,), generator=g, device=dev)
        local = lbl_g - shard * v
        valid = ((lbl_g >= 0) & (lbl_g < vt)).float()
        parts = slx.linear_xent_parts(x, w, local)
        p_parts = slx.linear_xent_parts_plain(x, w, local)
        args = (x, w, local, valid, p_parts[0] + 0.5, dy, eps, vt)
        sdx, sdw = slx.linear_xent_dx_sharded(*args), slx.linear_xent_dw_sharded(*args)
        p_sdx, p_sdw = slx.linear_xent_grad_sharded_plain(*args)
        errs = {"loss": _rel(loss, p_loss), "lse": _rel(lse, p_lse),
                "dx": _rel(dx, p_dx), "dw": _rel(dw, p_dw),
                "parts": max(_rel(a, b) for a, b in zip(parts, p_parts)),
                "dx_sharded": _rel(sdx, p_sdx), "dw_sharded": _rel(sdw, p_sdw)}
        worst = max(worst, *errs.values())
        print("[%d, %d] x [%d, %d] eps %.1f plan %s rerun bit-equal %s: %s" % (
            r, h, h, v, eps, tuple(lx.lxent_plan(r, h, v)), same,
            {k: "%.3g" % e for k, e in errs.items()}), flush=True)
        assert same, "rerun differs"
    assert worst <= 1e-4, ("disagrees", worst)

    for tag, r, h, v in PATHS:
        x, w = randn(r, h), randn(h, v, scale=h ** -0.5)
        lbl = torch.randint(0, v, (r,), generator=g, device=dev)
        dy = torch.rand(r, 1, generator=g, device=dev)
        _, lse = lx.linear_xent_fwd(x, w, lbl, 0.0)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

        def lib_fwd_bwd():
            loss = F.cross_entropy(torch.matmul(xg, wg), lbl, reduction="none")
            return torch.autograd.grad(loss, (xg, wg), dy.reshape(-1))

        ms = {
            "fwd": chip_smoke._events_ms(lambda: lx.linear_xent_fwd(x, w, lbl, 0.0)),
            "dx": chip_smoke._events_ms(lambda: lx.linear_xent_dx(x, w, lbl, lse, dy, 0.0)),
            "dw": chip_smoke._events_ms(lambda: lx.linear_xent_dw(x, w, lbl, lse, dy, 0.0)),
            "library_fwd": chip_smoke._events_ms(lambda: F.cross_entropy(
                torch.matmul(x, w), lbl, reduction="none")),
            "library_fwd_bwd": chip_smoke._events_ms(lib_fwd_bwd)}
        flops = 2 * r * h * v
        ms["bound_3xtf32_fwd"] = flops / chip_smoke.TF32X3_FLOPS_PER_S * 1e3
        print("%s [%d, %d] x [%d, %d]: %s" % (tag, r, h, h, v, json.dumps(
            {k: round(t, 4) for k, t in ms.items()})), flush=True)

    if full:
        for check in (chip_smoke.check_linear_xent,
                      chip_smoke.check_sharded_linear_xent):
            t0 = time.time()
            for name, rec in check(dev, randn, g).items():
                print(name, json.dumps(rec))
            print("%s: %.1f s" % (check.__name__, time.time() - t0), flush=True)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("linear_xent_check: no CUDA device", file=sys.stderr)
        return 2
    if "--child" in sys.argv[1:]:
        return child("--full" in sys.argv[1:])
    import chip_smoke

    print(chip_smoke._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]), flush=True)
    timeout = 600
    if "--timeout" in sys.argv[1:]:
        timeout = int(sys.argv[sys.argv.index("--timeout") + 1])
    cmd = [sys.executable, os.path.abspath(__file__), "--child"] + [
        a for a in sys.argv[1:] if a == "--full"]
    try:
        return subprocess.run(cmd, timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        print("linear_xent_check: the check did not end within %d s" % timeout,
              file=sys.stderr)
        return 124


if __name__ == "__main__":
    sys.exit(main())
