#!/usr/bin/env python3
"""Profiles the two serving steps of chip_smoke.py (GPT-2 small and
TinyLlama's widths, each over its seeded 24-request trace) from the tree
at --root, with that tree's own chip_smoke.py and kernels, and prints a
step's wall, device busy time and idle share, and the device time of
the qvec forward's kernels (flash_attention_qvec, B8) a step.  To hold
two trees against each other on one card, unpack the older one under
build/ (git archive) and run the script in both, older, newer, newer,
older, in one call:

    python3 scripts/serving_profile.py [--root build/parent] --tag parent

The profiles (chip_smoke.profile_serving's JSON) go to
chiprun_out/serving_profile/profile_<tag>_<n>_{serving,serving_llama}.json.
"""

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE,
                        help="the tree whose chip_smoke.py and kernels run")
    parser.add_argument("--tag", default="tree")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serving_profile: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = importlib.import_module("chip_smoke")
    from paddle_tpu_torch.kernels import build

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load()
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(HERE, "chiprun_out", "serving_profile")
    os.makedirs(out_dir, exist_ok=True)
    n = len([f for f in os.listdir(out_dir)
             if f.startswith("profile_%s_" % args.tag)]) // 2
    print(cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0])
    for serve, name in ((cs.serve_gpt2_small, "serving"),
                        (cs.serve_tinyllama, "serving_llama")):
        _, eng, scope = serve(dev)
        label = "%s_%d_%s" % (args.tag, n, name)
        cs.profile_serving(eng, scope, out_dir, name=label)
        del eng, scope
        torch.cuda.empty_cache()
        with open(os.path.join(out_dir, "profile_%s.json" % label)) as f:
            prof = json.load(f)
        steps = prof["steps"]
        qvec = sum(us for kernel, us in prof["device_us_by_kernel"].items()
                   if "qvec" in kernel) / steps / 1e3
        print("%s %s: wall %.3f ms a step, busy %.4f, idle %.4f, "
              "flash_attention_qvec %.4f ms a step" % (
                  args.tag, name, prof["wall_us"] / steps / 1e3,
                  prof["device_busy_us"] / steps / 1e3,
                  prof["device_idle_share"], qvec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
