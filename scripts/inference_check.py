#!/usr/bin/env python3
"""The inference deployment path's phases of chip_smoke.py alone, on one
CUDA card:

    python3 scripts/inference_check.py            # from the repository root
    python3 scripts/inference_check.py --profile  # also keep the profiler
                                                  # reports (chiprun_out/)

Builds the kernels, holds them against their plain versions at the
inference paths' shapes (chip_smoke.check_inference_kernels: B3 at the
encoder's [256, 256, 64] with a key bias, B5 at its FFN and the
classifiers' and LSTM's fc, B1 at [8192, 512], B11 forward-only), then
serves ResNet-50, the Transformer-base encoder classifier and the
stacked LSTM through save_inference_model and
create_paddle_predictor(AnalysisConfig) (chip_smoke.resnet50_inference,
transformer_encoder_inference, lstm_inference) and runs the narrow
predictors card against CPU (chip_smoke.inference_card_matches_cpu),
with every check those hold.  Prints each path's eager and captured
numbers as one JSON line.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("inference_check: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs

    dev, smi = cs.card_setup()
    from paddle_tpu_torch.kernels import build

    t0 = time.time()
    build.load()
    print("kernels built in %.1f s" % (time.time() - t0))
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rec = {name: {"per_shape": {}} for name in (
        "flash_attention_fwd", "matmul_bias_act", "fused_layer_norm",
        "fused_lstm")}
    t0 = time.time()
    cs.check_inference_kernels(dev, randn, rec)
    print("phase inference kernels: %.1f s" % (time.time() - t0))
    profile_dir = (os.path.join(ROOT, "chiprun_out")
                   if "--profile" in sys.argv[1:] else None)
    caps = {}
    for name, path in (("resnet50_inference", cs.resnet50_inference),
                       ("transformer_encoder_inference",
                        cs.transformer_encoder_inference),
                       ("lstm_inference", cs.lstm_inference)):
        t0 = time.time()
        torch.cuda.empty_cache()
        _, caps[name] = path(dev, profile_dir)
        print("phase %s: %.1f s" % (name, time.time() - t0))
    t0 = time.time()
    cs.inference_card_matches_cpu(dev)
    print("phase narrow predictors, card vs CPU: %.1f s" % (time.time() - t0))
    print("eager and captured, each path (%s): %s" % (smi, json.dumps(caps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
