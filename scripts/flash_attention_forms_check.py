#!/usr/bin/env python3
"""A short on-card check of flash attention's tile kernels
(csrc/flash_attention.cu): builds the kernel library, prints ptxas's
register and spill lines for flash_attention.cu, runs chip_smoke.py's
flash-attention kernel checks (B3 at every path's shapes, the packed
LM's segment and window forms, ragged T, head dim 128, the tensor-core
tiles' edges; B9 with and without a window, the B8 backward), then times
dq at WMT's 64 x 64 shapes in the SIMT form, which flash_plan gives
there, against the tensor-core form in the same call, in turns (SIMT,
tensor cores, tensor cores, SIMT), then the narrow packed LM card vs
CPU at window 0 and 48 and one packed-LM training run at GPT-2 small's
widths (window 256).

    python3 scripts/flash_attention_forms_check.py          # one card, nvcc
    python3 scripts/flash_attention_forms_check.py --quick  # checks only

It takes a few minutes, most of it the timings beside the checks; with
--quick, under a minute past the build: the first call for a change to
csrc/flash_attention.cu, before a full chip_smoke.py run.
"""

import argparse
import importlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402

fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")


def dq_form_times(randn, tag, bh, t, causal):
    """Device ms of dq at a d-64 shape within 64 x 64, where flash_plan
    runs the SIMT form, in the SIMT form and the tensor-core form, in
    turns (SIMT, tensor cores, tensor cores, SIMT), with the 3xTF32 bound
    of the visible pairs (the causal half, or every pair under a
    key-padding bias masking the last quarter of the keys, as
    chip_smoke._flash_times)."""
    d, scale = 64, 0.125
    q, k, v, do = (randn(bh, t, d) for _ in range(4))
    kb = None
    if not causal:
        kb = torch.zeros(bh, t, device=q.device)
        kb[:, t - t // 4:] = -1e9
    o, lse = fa.flash_attention_fwd(q, k, v, kb, causal, scale)
    delta = (do * o).sum(-1)
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    dq = torch.empty_like(q)

    def run(form):  # _dq's launch with the form named here
        build.launch("ptt_flash_attention_dq", q, k, v, kb, None, lse, do,
                     delta, dq, bh, t, t, d, form, int(causal), 0, scale, 0,
                     None)

    assert fa.flash_plan("dq", t, t, d) == fa.FLASH_SIMT
    simt = [chip_smoke._time_ms(lambda: run(fa.FLASH_SIMT), inner=5)]
    tc = [chip_smoke._time_ms(lambda: run(fa.FLASH_TC), inner=5)
          for _ in range(2)]
    simt.append(chip_smoke._time_ms(lambda: run(fa.FLASH_SIMT), inner=5))
    print(tag, "dq, q, k, v [%d, %d, %d]" % (bh, t, d), dict(
        simt_ms=simt, tc_ms=tc,
        bound_3xtf32_ms=6 * pairs * d / chip_smoke.TF32X3_FLOPS_PER_S * 1e3))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="build and check only: no timings, no training")
    args = parser.parse_args()
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
        rec = check(dev, randn, times=not args.quick)
        for name, r in rec.items():
            print(name, {k: r[k] for k in ("max_abs_err", "max_rel_err",
                                           "ms", "bound_ms") if k in r})
            for shape, times in r.get("per_shape", {}).items():
                print("   ", shape, {k: times[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms")})
        print("%s: %.1f s" % (check.__name__, time.time() - t0))
    if args.quick:
        print("ok")
        return 0
    cs = chip_smoke
    wmt_bh = cs.TRAIN_BATCH * cs.HP_HEADS
    dq_form_times(randn, "wmt", wmt_bh, cs.TRAIN_LEN, False)
    dq_form_times(randn, "wmt decoder", wmt_bh, cs.TRAIN_LEN, True)
    chip_smoke.packed_train_card_matches_cpu(dev)
    chip_smoke.train_packed_lm(dev, chip_smoke.PACKED_WINDOW)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
