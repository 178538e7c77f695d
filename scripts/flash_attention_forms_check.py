#!/usr/bin/env python3
"""A short on-card check of flash attention's segment-id and
sliding-window forms (csrc/flash_attention.cu): builds the kernel
library, prints ptxas's register and spill lines for flash_attention.cu,
runs chip_smoke.py's flash-attention kernel checks (B3 at every path's
shapes, the packed LM's segment and window forms, ragged T, head dim
128; B9 with and without a window, the B8 backward), then the narrow
packed LM card vs CPU at window 0 and 48 and one packed-LM training run
at GPT-2 small's widths (window 256).

    python3 scripts/flash_attention_forms_check.py   # one CUDA card, nvcc

It takes about two minutes, most of it the timings beside the checks:
the quick first call for a change to csrc/flash_attention.cu before a
full chip_smoke.py run.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("flash_attention_forms_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]))
    t0 = time.time()
    build.load()
    print("built in %.1f s" % (time.time() - t0))
    log = build.build_log
    print(log[log.find("== flash_attention.cu"):].split("\n== ")[0])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    for check in (chip_smoke.check_flash_attention,
                  chip_smoke.check_attention_pieces):
        t0 = time.time()
        rec = check(dev, randn)
        for name, r in rec.items():
            print(name, {k: r[k] for k in ("max_abs_err", "max_rel_err",
                                           "ms", "bound_ms") if k in r})
            for shape, times in r.get("per_shape", {}).items():
                print("   ", shape, {k: times[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms")})
        print("%s: %.1f s" % (check.__name__, time.time() - t0))
    chip_smoke.packed_train_card_matches_cpu(dev)
    chip_smoke.train_packed_lm(dev, chip_smoke.PACKED_WINDOW)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
