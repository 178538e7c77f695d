#!/usr/bin/env python3
"""The DeepFM phases of chip_smoke.py alone, on one CUDA card:

    python3 scripts/deepfm_check.py            # from the repository root
    python3 scripts/deepfm_check.py --profile  # also keep the profiler
                                               # reports (chiprun_out/)

Builds the kernels, holds B5 against its plain version at DeepFM's three
fc shapes (chip_smoke.check_deepfm_kernels), then trains DeepFM as
BASELINE.json config 4 with sparse tables, unfused and through
matmul_epilogue_fuse_pass (chip_smoke.train_deepfm), the wide tables
sparse against dense (chip_smoke.train_deepfm_wide) and the narrow
config card against CPU under every optimizer
(chip_smoke.deepfm_card_matches_cpu), with every check those hold.
Prints each leg's eager and captured numbers as one JSON line.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("deepfm_check: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    dev, smi = cs.card_setup()
    from paddle_tpu_torch.kernels import build

    t0 = time.time()
    build.load()
    print("kernels built in %.1f s" % (time.time() - t0))
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rec = {"matmul_bias_act": {"per_shape": {}}}
    t0 = time.time()
    cs.check_deepfm_kernels(dev, randn, rec)
    print("phase DeepFM kernels: %.1f s" % (time.time() - t0))
    profile_dir = (os.path.join(ROOT, "chiprun_out")
                   if "--profile" in sys.argv[1:] else None)
    caps, launches = {}, {}
    t0 = time.time()
    launches["unfused"], caps["deepfm_training"] = cs.train_deepfm(
        dev, False, profile_dir)
    launches["fused"], caps["deepfm_fused_training"] = cs.train_deepfm(
        dev, True, profile_dir, base=caps["deepfm_training"])
    print("phase DeepFM training: %.1f s" % (time.time() - t0))
    t0 = time.time()
    torch.cuda.empty_cache()
    launches["wide"], wide = cs.train_deepfm_wide(dev, profile_dir)
    caps.update({"deepfm_wide_" + k: v for k, v in wide.items()})
    print("phase DeepFM wide tables: %.1f s" % (time.time() - t0))
    t0 = time.time()
    cs.deepfm_card_matches_cpu(dev)
    print("phase narrow DeepFM, card vs CPU: %.1f s" % (time.time() - t0))
    print("launches per leg: %s" % json.dumps(
        {k: {n: c for n, c in v.items() if c} for k, v in launches.items()}))
    print("eager and captured, each leg (%s): %s" % (smi, json.dumps(caps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
