#!/usr/bin/env python3
"""The serving fabric's phases of chip_smoke.py alone, on one CUDA card:

    python3 scripts/fabric_check.py            # from the repository root
    python3 scripts/fabric_check.py --profile  # also profile a window of
                                               # the static pools
                                               # (chiprun_out/)

Builds the kernels, serves GPT-2 small once (chip_smoke.serve_gpt2_small,
whose scope holds the weights the pools copy), then runs
chip_smoke.serve_gpt2_small_fabric (three static pools, a seeded pool
kill, 1 -> 3 -> 1) and chip_smoke.fabric_card_matches_cpu, with every
check those hold.  About 70 s of command on the H100.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("fabric_check: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    dev, smi = cs.card_setup()
    from paddle_tpu_torch.kernels import build

    t0 = time.time()
    build.load()
    print("kernels built in %.1f s" % (time.time() - t0))
    _, eng, scope, _, (_, stats) = cs.serve_gpt2_small(dev)
    print("one engine: %.1f tokens/s, step p50 %.3f ms" % (
        stats["tokens_per_s"], stats["step_s_p50"] * 1e3))
    eng.exe.close()
    del eng
    t1 = time.time()
    profile_dir = (os.path.join(ROOT, "chiprun_out")
                   if "--profile" in sys.argv[1:] else None)
    cs.serve_gpt2_small_fabric(dev, scope, smi, profile_dir)
    print("fabric phase %.1f s" % (time.time() - t1))
    t1 = time.time()
    cs.fabric_card_matches_cpu(dev)
    print("narrow fabric card vs CPU %.1f s; total %.1f s" % (
        time.time() - t1, time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
