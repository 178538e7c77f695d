#!/usr/bin/env python3
"""Times every split that the two kernels redesigned for the decode
steps can take, at the paths' shapes on the card, and prints each plan
function's pick beside the fastest:

- B3's few-row forward (B3d, csrc/flash_attention_rows.cu): key slices
  of 64, 128 and 256 keys (64 and 128 at head dim 128) at chip_smoke's
  DECODE_ATTENTION shapes, against rows_plan's pick;
- fused_layer_norm (B1, csrc/layer_norm.cu): the register form at 1, 2,
  4 and 8 rows a block and the block form, at chip_smoke's layer-norm
  shapes, against ln_plan's pick.

Beside B3d's splits it times the kernel that the few-row form replaced
on the decode paths, flash_attention.cu's tile forward, at the same
inputs; the block form is the one B1's register form replaced.

Each candidate is launched through build.launch with its own plan ints,
as scripts/matmul_check.py --plans does (the wrappers take the plan
functions' picks only), and is first held against its plain version:
1e-5 absolute on o, mean and variance, and on lse relative to max(1,
|lse|); the few-row split is also held at its edges (BH_TQ_TK_D_EDGES),
a split of 64 keys at head dim 128 included.  chip_smoke.py's kernel
phase holds the picks themselves.  Times are chip_smoke's (CUDA graph
replays, the median of 5).

    python3 scripts/decode_kernels_check.py
"""

import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (BH, Tq, Tk, d): Tq 1, 3, 5 and 8; Tk ragged, below one slice, one key
# past a slice (the last slice of one key, the block's second warp idle)
BH_TQ_TK_D_EDGES = ((3, 1, 1000, 64), (5, 3, 300, 64), (2, 8, 40, 64),
                    (3, 1, 7, 64), (6, 2, 4000, 64), (3, 8, 1000, 128),
                    (2, 1, 2050, 128), (1, 5, 129, 128))


def rows_launch(q, k, v, kb, plan):
    """(o, lse) of the few-row kernel at `plan` (slice_len, slices)."""
    import torch

    from paddle_tpu_torch.kernels import build

    bh, tq, d = q.shape
    tk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, device=q.device)
    parts = (None, None)
    if plan[1] > 1:
        parts = tuple(torch.empty(bh, tq, plan[1], n, device=q.device)
                      for n in (d, 2))
    build.launch("ptt_flash_attention_rows", q, k, v, kb, o, lse, *parts,
                 bh, tq, tk, d, *plan, d ** -0.5)
    return o, lse


def rows_splits(tk, d):
    """Every (slice_len, slices) the few-row kernel takes at Tk, d."""
    out = []
    for s in (64, 128, 256) if d == 64 else (64, 128):
        s = min(s, 32 * -(-tk // 32))
        if (s, -(-tk // s)) not in out:
            out.append((s, -(-tk // s)))
    return out


def ln_launch(x, gam, bet, plan):
    """(out, mean, var) of the layer-norm kernel at `plan` (form, n4,
    vec, rows)."""
    import torch

    from paddle_tpu_torch.kernels import build

    r, h = x.shape
    out = torch.empty_like(x)
    mean = torch.empty(r, device=x.device)
    var = torch.empty(r, device=x.device)
    build.launch("ptt_layer_norm", x, gam, bet, out, mean, var, r, h, *plan,
                 1e-5)
    return out, mean, var


def ln_forms(r, h):
    """Every form the layer-norm kernel takes at [R, H]: the register
    form (H <= WARP_MAX_H) at 1, 2, 4 and 8 rows a block and ln_plan's
    own count, and the block form."""
    from paddle_tpu_torch.kernels import layer_norm as ln

    out = [ln.LnPlan(ln.BLOCK, 0, 0, 0)]
    if h <= ln.WARP_MAX_H:
        warp = ln.ln_plan(r, h)
        out = [warp._replace(rows=n)
               for n in sorted({1, 2, 4, 8, warp.rows})] + out
    return out


def held(got, want, what):
    """Max abs error of o (or every output), relative on an lse."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        diff = (a - b).abs()
        if what == "rows" and i == 1:
            diff = diff / b.abs().clamp_min(1.0)
        err = max(err, diff.max().item())
    return err


def main():
    import torch

    if not torch.cuda.is_available():
        print("decode_kernels_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import (flash_attention_plain,
                                          layer_norm_plain)
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels.flash_attention import NEG_INF, rows_plan

    # the module (the package exports a function of the same name)
    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def key(plan):
        return "/".join(str(int(v)) for v in plan)

    worst = 0.0
    shapes = [(bh, tq, tk, d, None) for bh, tq, tk, d in BH_TQ_TK_D_EDGES]
    shapes += [(bh, tq, tk, d, (tag, pos))
               for tag, bh, tq, tk, d, pos in cs.DECODE_ATTENTION]
    for bh, tq, tk, d, path in shapes:
        q, k, v = randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d)
        if path is None:  # as chip_smoke's edges: all-masked, -1e9 keys
            kb = randn(bh, tk)
            kb[0] = NEG_INF
            kb[-1, :tk // 2] = -1e9
            kb[-1, -3:] = -1e9
        else:  # decode_pos_mask's bias: the cache's tail masked
            kb = torch.zeros(bh, tk, device=dev)
            kb[:, path[1] + 1:] = NEG_INF
        want = flash_attention_plain(q, k, v, kb, False, d ** -0.5)
        row = {}
        for plan in rows_splits(tk, d):
            got = rows_launch(q, k, v, kb, plan)
            err = held(got, want, "rows")
            worst = max(worst, err)
            assert err <= 1e-5, ("few-row split disagrees", bh, tq, tk, d,
                                 plan, err)
            if path is not None:
                row[key(plan)] = cs._time_ms(
                    lambda: rows_launch(q, k, v, kb, plan))
        if path is not None:
            tile = cs._time_ms(lambda: fa._fwd("tile forward", q, k, v, kb,
                                               False, d ** -0.5))
            pick = key(rows_plan(tk, d))
            best = min(row, key=row.get)
            print("B3d %s q [%d, %d, %d] k/v [%d, %d, %d]: pick %s %.6f, "
                  "fastest %s %.6f, the tile kernel %.6f; %s" % (
                      path[0], bh, tq, d, bh, tk, d, pick, row[pick], best,
                      row[best], tile, json.dumps(row)), flush=True)
    for tag, r, h in ((("gpt2_train", cs.GPT2_ROWS, cs.GPT2_D),
                       ("bert_train", cs.BERT_ROWS, cs.BERT_D),
                       ("llama_train", cs.LLAMA_ROWS, cs.LLAMA_D),
                       ("llama_serve", cs.N_SLOTS * cs.WIDTH, cs.LLAMA_D))
                      + cs.DECODE_ROWS):
        x, gam, bet = randn(r, h) * 2.0 + 0.5, randn(h), randn(h)
        want = layer_norm_plain(x, gam, bet, 1e-5)
        row = {}
        for plan in ln_forms(r, h):
            err = held(ln_launch(x, gam, bet, plan), want, "ln")
            worst = max(worst, err)
            assert err <= 1e-5, ("layer-norm form disagrees", r, h, plan,
                                 err)
            row[key(plan)] = cs._time_ms(lambda: ln_launch(x, gam, bet,
                                                           plan))
        pick = key(ln.ln_plan(r, h))
        best = min(row, key=row.get)
        print("B1 %s [%d, %d]: pick %s %.6f, fastest %s %.6f; %s" % (
            tag, r, h, pick, row[pick], best, row[best], json.dumps(row)),
            flush=True)
    print("every split held against its plain version: worst error %.3g"
          % worst, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
