#!/usr/bin/env python3
"""A short on-card check of the recurrent kernels of paddle_tpu_torch:
builds the kernel library, prints ptxas's register and spill lines for
recurrent.cu, and runs fused_lstm (B11) and fused_gru (B10) against
their plain PyTorch versions at the recurrent paths' shapes (full and
ragged lengths, T 1 from a nonzero h0, H 200 and 16), printing for each
the largest absolute difference, whether a rerun is bit-equal and the
device time of one call (CUDA events around 10 calls).

    python3 scripts/recurrent_kernel_check.py   # one CUDA card, nvcc

It takes well under a minute, most of it the build: the quick first
call for a change to csrc/recurrent.cu before a full chip_smoke.py run.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from paddle_tpu_torch.kernels import (  # noqa: E402
    build,
    fused_gru,
    fused_lstm,
    gru_seq_plain,
    lstm_seq_plain,
)

SHAPES = ((32, 64, 512, False), (32, 64, 512, True), (32, 50, 512, False),
          (8, 1, 512, False), (5, 7, 200, True), (4, 12, 16, True))


def main():
    if not torch.cuda.is_available():
        print("recurrent_kernel_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.load()
    print("built in %.1f s" % (time.time() - t0))
    log = build.build_log
    print(log[log.find("== recurrent"):].split("\n== ")[0])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    for b, t, h, ragged in SHAPES:
        if ragged:
            lens = torch.randint(0, t + 1, (b,), generator=g, device=dev)
            lens[0], lens[1], lens[-1] = 0, 1, t
        else:
            lens = torch.full((b,), t, device=dev, dtype=torch.long)
        for gates in (4, 3):
            x = randn(b, t, gates * h)
            w = randn(h, gates * h, scale=h ** -0.5)
            h0, c0 = randn(b, h), randn(b, h)
            if gates == 4:
                def run():
                    return fused_lstm(x, w, h0, c0, lens)
                want = lstm_seq_plain(x, w, h0, c0, lens)
            else:
                def run():
                    return (fused_gru(x, w, h0, lens),)
                want = (gru_seq_plain(x, w, h0, lens),)
            got = run()
            err = max((a - c).abs().max().item() for a, c in zip(got, want))
            bit = all(torch.equal(a, c) for a, c in zip(got, run()))
            run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                run()
            end.record()
            torch.cuda.synchronize()
            print(json.dumps(dict(
                kind="lstm" if gates == 4 else "gru", B=b, T=t, H=h,
                lens="ragged" if ragged else "full", max_abs_err=err,
                bit_equal_rerun=bit, ms=start.elapsed_time(end) / 10)))
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
