#!/usr/bin/env python3
"""Holds the bf16 forms of seven kernels against their plain versions on
the card, and times them at the bf16 paths' shapes:

- matmul_bias_act (B5, csrc/matmul_bias_act.cu's mm_tiled_bf16): the WMT
  FFN, [4096, 512] @ [512, 2048] + bias, relu and [4096, 2048] @ [2048,
  512] + bias, against torch.addmm (+ relu) in bf16;
- fused_layer_norm (B1, csrc/layer_norm.cu's bf16 forms): 4096 x 512
  and BERT's MLM transform 4096 x 768, against F.layer_norm in bf16;
- fused_add_layer_norm (B2, csrc/add_layer_norm.cu's bf16 form): 4096 x
  512, against F.layer_norm(x + y) in bf16;
- fused_linear_xent's three kernels (B4, csrc/linear_xent_bf16.cu): x
  4096 x 512, w 512 x 10000, eps 0.1 (WMT) and BERT's MLM head, x 4096 x
  768, w 768 x 30522, against torch.matmul + F.cross_entropy in bf16
  (forward; forward and backward for dx and dw); and bit-equal to their
  forms before B12's bf16 forms joined the file
  (scripts/linear_xent_bf16_before.cu, built into a library of its own)
  at both shapes;
- sharded_linear_xent's three kernels (B12, csrc/linear_xent_bf16.cu):
  parts, dx and dw on the vocab-parallel WMT step's slab, x 4096 x 512,
  w_local 512 x 5000 of 10000, eps 0.1, against one bf16 matmul +
  logsumexp + gold gather + row sum (parts) and the dense bf16 backward
  (dx and dw), beside the float32 forms on the widened values;
- flash attention's forward, dq and dk/dv (B3,
  csrc/flash_attention_bf16.cu): GPT-2 96 x 1024 x 64 causal, TinyLlama
  64 x 2048 x 64 causal, BERT 384 x 128 x 64 with a key-padding bias,
  WMT 512 x 64 x 64 with a key bias, causal, and Tq != Tk (64 queries
  over 96 keys), the packed 96 x 1024 x 64 with segment ids and window
  256, d 128 (the SIMT form widening its operands) and a row whose keys
  are all at NEG_INF, against the plain versions (float32 arithmetic on
  the widened operands) and scaled_dot_product_attention in bf16
  (forward, and forward and backward);
- matmul_swiglu (B6, csrc/matmul_bias_act.cu's gated mm_tiled_bf16):
  TinyLlama's [4096, 2048] @ [2048, 5632] and M, N off the tile, against
  two bf16 matmuls and silu(g) u.

Each form first meets its plain version at the path shapes and at the
edges of its staging (K, N, H or V not a multiple of 8: element loads in
place of 16-byte copies; ragged M, R and V; K slices; H past one pass of
dx / dw; labels -1 and V; segment ids, windows, Tq != Tk, ragged T,
an all-NEG_INF key row), every rerun bit-equal.  Limits: a bf16
output within one bf16 unit in the last place of the plain version
(|d| <= 2^-7 |plain| + 1e-5 max |plain|: both round a float32 value
that differs only in the order of its sums); flash attention's and
matmul_swiglu's bf16 outputs within one bf16 unit in the last place of
their largest magnitude (_one_unit; p and dS reach the second products
as a bf16 hi + lo pair) and equal to the plain version in 98% of their
elements (EQUAL_MIN, which a control with p and dS rounded once must
fail), the lse within 1e-5 relative, dkbias within
1e-4 of its largest magnitude; B4's loss and lse and B12's lse, gold
and sum (float32) within 1e-5 of the largest magnitude; their dx and
dw within 1e-2 of the largest magnitude (g is rounded to bf16 before
the product, and a float32 logit that differs in its last bits may
round g the other way).  Times are chip_smoke's (CUDA graph replays, the median of 5;
B4 at BERT's shape and the plain backward CUDA events); bounds are the larger of bytes over 3.35 TB/s and FLOPs over bf16's
dense tensor-core rate, 989 TFLOP/s.

    python3 scripts/bf16_kernels_check.py [--checks-only]

chip_smoke.py's kernel phase calls check_bf16(); its records are the
bf16 forms' entries of the kernels line.
"""

import ctypes
import hashlib
import importlib
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WMT_ROWS, WMT_D, WMT_FF, WMT_VOCAB = 4096, 512, 2048, 10000
BERT_D = 768

# (M, K, N, act): the WMT FFN, then the staging edges
MM_CASES = ((WMT_ROWS, WMT_D, WMT_FF, "relu"), (WMT_ROWS, WMT_FF, WMT_D, ""),
            (37, 100, 70, "gelu"), (37, 100, 70, "tanh"),
            (37, 100, 70, "sigmoid"), (37, 100, 70, "swish"),
            (100, 1000, 333, "gelu"), (17, 768, 3072, "gelu"),
            (1, 512, 2048, "relu"), (45, 1600, 90, "swish"),
            (300, 2048, 512, ""))
# (R, H): the paths' rows, then the register form's edges (H % 8 != 0,
# one slot, three slots) and the block form (H 2048)
LN_CASES = ((WMT_ROWS, WMT_D), (WMT_ROWS, BERT_D), (37, 100), (5, 1001),
            (300, 1024), (64, 2048), (3, 8))
ADD_LN_CASES = ((WMT_ROWS, WMT_D), (WMT_ROWS, BERT_D), (64, 2048),
                (37, 100), (5, 1001), (300, 1025), (9, 16384))
# (R, H, V, eps): the WMT step, then ragged V (odd: element loads of w),
# H % 8 != 0 (element loads of x), two and three dx / dw passes, and R
# 4096 over V 300, whose 5 vocab tiles in fwd_splits' 4 splits of 2 leave
# the last split without a tile (ROADMAP C14: only the splits that hold
# a tile launch)
LX_CASES = ((WMT_ROWS, WMT_D, WMT_VOCAB, 0.1), (100, 96, 333, 0.0),
            (64, 100, 1000, 0.1), (300, 768, 1000, 0.0),
            (70, 1100, 301, 0.1), (8191, 512, 777, 0.1), (300, 64, 1002, 0.1),
            (WMT_ROWS, 64, 300, 0.1))
# BERT's MLM head (V % 8 = 2: 4-byte copies of w; H 768: two dx / dw
# passes), timed beside the WMT shape
LX_BERT = (4096, BERT_D, 30522, 0.0)


def _ulp_err(out, ref):
    """max over elements of |out - ref| - 2^-7 |ref| (<= 1e-5 max |ref|
    when out is within one bf16 unit in the last place), and the max
    absolute difference."""
    a, b = out.float(), ref.float()
    d = (a - b).abs()
    slack = (d - 2.0 ** -7 * b.abs()).max().item()
    return slack / max(b.abs().max().item(), 1e-30), d.max().item()


def _bound(cs, nbytes, flops):
    t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
    t_ops = flops / cs.BF16_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_matmul(cs, dev, randn, times=True):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import matmul_epilogue as me

    bf = torch.bfloat16
    worst, err = -1.0, 0.0
    for m, k, n, act in MM_CASES:
        x = randn(m, k).to(bf)
        w = randn(k, n, scale=k ** -0.5).to(bf)
        b = randn(n).to(bf)
        for bias in (b, None):
            out = me.matmul_bias_act(x, w, bias, act)
            assert out.dtype == bf and out.shape == (m, n), out.dtype
            ref = me.matmul_bias_act_plain(x, w, bias, act)
            slack, d = _ulp_err(out, ref)
            worst, err = max(worst, slack), max(err, d)
            assert torch.equal(out, me.matmul_bias_act(x, w, bias, act)), (
                "matmul_bias_act bf16 rerun", m, k, n, act)
        print("matmul_bias_act bf16 [%d, %d] @ [%d, %d] %s: plan %s, ulp "
              "slack %.3g" % (m, k, k, n, act or "identity",
                              tuple(me.mm_plan(m, n, k, bf16=True)), worst))
    assert worst <= 1e-5, ("matmul_bias_act bf16 disagrees", worst)
    rec = dict(route="cuda",
               source="paddle_tpu_torch/kernels/csrc/matmul_bias_act.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:1257",
               max_abs_err=err, ulp_slack=worst)
    if not times:
        return rec
    per = {}
    for tag, (m, k, n, act) in (("train_ffn_in", MM_CASES[0]),
                                ("train_ffn_out", MM_CASES[1]),
                                ("bert_ffn_in", (4096, BERT_D, 3072, "relu")),
                                ("bert_ffn_out", (4096, 3072, BERT_D, ""))):
        x = randn(m, k).to(bf)
        w = randn(k, n, scale=k ** -0.5).to(bf)
        b = randn(n).to(bf)
        fn = F.relu if act == "relu" else (lambda z: z)
        per[tag] = dict(
            shape="[%d, %d] @ [%d, %d] + bias%s, bf16" % (
                m, k, k, n, ", " + act if act else ""),
            ms=cs._time_ms(lambda: me.matmul_bias_act(x, w, b, act)),
            plain_ms=cs._time_ms(lambda: me.matmul_bias_act_plain(x, w, b, act)),
            library_ms=cs._time_ms(lambda: fn(torch.addmm(b, x, w))),
            plan=list(me.mm_plan(m, n, k, bf16=True)),
            **_bound(cs, 2 * (m * k + k * n + n + m * n), 2 * m * k * n))
        print("matmul_bias_act bf16 %s: %s" % (tag, json.dumps(per[tag])))
    rec.update(per["train_ffn_in"])
    rec["shape"] = ("WMT ffn_in " + per["train_ffn_in"]["shape"]
                    + " (ffn_out and BERT's FFN in per_shape)")
    rec["per_shape"] = per
    return rec


def check_layer_norm(cs, dev, randn, times=True):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import layer_norm as ln

    bf = torch.bfloat16
    worst, err, stat = -1.0, 0.0, 0.0
    for r, h in LN_CASES:
        x = (randn(r, h) * 3 + 1).to(bf)
        gam, bet = randn(h) * 0.5 + 1, randn(h) * 0.1
        out, mean, var = ln.fused_layer_norm(x, gam, bet)
        assert out.dtype == bf and mean.dtype == torch.float32
        ref, rmean, rvar = ln.layer_norm_plain(x, gam, bet)
        slack, d = _ulp_err(out, ref)
        worst, err = max(worst, slack), max(err, d)
        stat = max(stat, (mean - rmean).abs().max().item(),
                   (var - rvar).abs().max().item() / rvar.abs().max().item())
        assert torch.equal(out, ln.fused_layer_norm(x, gam, bet)[0]), (
            "fused_layer_norm bf16 rerun", r, h)
        print("fused_layer_norm bf16 [%d, %d]: plan %s, ulp slack %.3g, "
              "statistics %.3g" % (r, h, tuple(ln.ln_plan(r, h)), worst, stat))
    assert worst <= 1e-5 and stat <= 1e-5, (
        "fused_layer_norm bf16 disagrees", worst, stat)
    rec = dict(route="cuda", source="paddle_tpu_torch/kernels/csrc/layer_norm.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:724",
               max_abs_err=err, ulp_slack=worst)
    if not times:
        return rec
    per = {}
    for tag, (r, h) in (("wmt", LN_CASES[0]), ("bert_mlm", LN_CASES[1])):
        x = randn(r, h).to(bf)
        gam, bet = randn(h), randn(h)
        gb, bb = gam.to(bf), bet.to(bf)
        per[tag] = dict(
            shape="x [%d, %d] bf16, gamma and beta float32" % (r, h),
            ms=cs._time_ms(lambda: ln.fused_layer_norm(x, gam, bet)),
            plain_ms=cs._time_ms(lambda: ln.layer_norm_plain(x, gam, bet)),
            library_ms=cs._time_ms(lambda: F.layer_norm(x, (h,), gb, bb)),
            **_bound(cs, 2 * 2 * r * h + 8 * h + 8 * r, 8 * r * h))
        print("fused_layer_norm bf16 %s: %s" % (tag, json.dumps(per[tag])))
    rec.update(per["wmt"])
    rec["per_shape"] = per
    return rec


def check_add_layer_norm(cs, dev, randn, times=True):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import add_layer_norm as aln

    bf = torch.bfloat16
    worst, err, stat = -1.0, 0.0, 0.0
    for r, h in ADD_LN_CASES:
        x, y = (randn(r, h) * 2).to(bf), (randn(r, h) + 1).to(bf)
        gam, bet = randn(h) * 0.5 + 1, randn(h) * 0.1
        s, out, mean, var = aln.fused_add_layer_norm(x, y, gam, bet)
        assert s.dtype == out.dtype == bf and mean.dtype == torch.float32
        rs, ref, rmean, rvar = aln.add_layer_norm_plain(x, y, gam, bet)
        assert torch.equal(s, rs), ("fused_add_layer_norm bf16 sum", r, h)
        slack, d = _ulp_err(out, ref)
        worst, err = max(worst, slack), max(err, d)
        stat = max(stat, (mean - rmean).abs().max().item(),
                   (var - rvar).abs().max().item() / rvar.abs().max().item())
        again = aln.fused_add_layer_norm(x, y, gam, bet)
        assert torch.equal(out, again[1]) and torch.equal(s, again[0]), (
            "fused_add_layer_norm bf16 rerun", r, h)
        print("fused_add_layer_norm bf16 [%d, %d]: plan %s, ulp slack %.3g, "
              "statistics %.3g" % (r, h, tuple(aln.add_ln_plan(r, h)), worst,
                                   stat))
    assert worst <= 1e-5 and stat <= 1e-5, (
        "fused_add_layer_norm bf16 disagrees", worst, stat)
    rec = dict(route="cuda",
               source="paddle_tpu_torch/kernels/csrc/add_layer_norm.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:1400",
               max_abs_err=err, ulp_slack=worst)
    if not times:
        return rec
    r, h = ADD_LN_CASES[0]
    x, y = randn(r, h).to(bf), randn(r, h).to(bf)
    gam, bet = randn(h), randn(h)
    gb, bb = gam.to(bf), bet.to(bf)
    rec.update(
        shape="train x, y [%d, %d] bf16, gamma and beta float32" % (r, h),
        ms=cs._time_ms(lambda: aln.fused_add_layer_norm(x, y, gam, bet)),
        plain_ms=cs._time_ms(lambda: aln.add_layer_norm_plain(x, y, gam, bet)),
        library_ms=cs._time_ms(lambda: F.layer_norm(x + y, (h,), gb, bb)),
        **_bound(cs, 4 * 2 * r * h + 8 * h + 8 * r, 10 * r * h))
    print("fused_add_layer_norm bf16: %s" % json.dumps(
        {k: v for k, v in rec.items() if k.endswith("ms")}))
    return rec


def check_linear_xent(cs, dev, randn, g, times=True):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import linear_xent as lx

    bf = torch.bfloat16
    err = {"loss": 0.0, "dx": 0.0, "dw": 0.0}
    err_abs = dict(err)

    def note(key, a, b):
        d = (a.float() - b.float()).abs().max().item()
        err_abs[key] = max(err_abs[key], d)
        err[key] = max(err[key], d / max(b.float().abs().max().item(), 1e-30))

    for r, h, v, e in LX_CASES + (LX_BERT,):
        x = randn(r, h).to(bf)
        w = randn(h, v, scale=h ** -0.5).to(bf)
        lbl = torch.randint(0, v, (r,), generator=g, device=dev)
        lbl[0], lbl[1] = -1, v  # outside the vocab: smoothing term only
        dy = torch.rand(r, 1, generator=g, device=dev)
        loss, lse = lx.linear_xent_fwd(x, w, lbl, e)
        assert loss.dtype == lse.dtype == torch.float32
        p_loss, p_lse = lx.linear_xent_plain(x, w, lbl, e)
        dx = lx.linear_xent_dx(x, w, lbl, lse, dy, e)
        dw = lx.linear_xent_dw(x, w, lbl, lse, dy, e)
        assert dx.dtype == dw.dtype == bf
        again = lx.linear_xent_fwd(x, w, lbl, e)
        assert torch.equal(loss, again[0]) and torch.equal(lse, again[1]), (
            "linear_xent_fwd bf16 rerun", r, h, v)
        assert torch.equal(dx, lx.linear_xent_dx(x, w, lbl, lse, dy, e)), (
            "linear_xent_dx bf16 rerun", r, h, v)
        assert torch.equal(dw, lx.linear_xent_dw(x, w, lbl, lse, dy, e)), (
            "linear_xent_dw bf16 rerun", r, h, v)
        p_dx, p_dw = lx.linear_xent_grad_plain(x, w, lbl, p_lse, dy, e)
        note("loss", loss, p_loss)
        note("loss", lse, p_lse)
        note("dx", dx, p_dx)
        note("dw", dw, p_dw)
        print("linear_xent bf16 [%d, %d] x [%d, %d] eps %.1f: relative error "
              "so far %s" % (r, h, h, v, e,
                             {k: "%.3g" % v_ for k, v_ in err.items()}))
    assert err["loss"] <= 1e-5, ("linear_xent_fwd bf16 disagrees", err)
    assert err["dx"] <= 1e-2 and err["dw"] <= 1e-2, (
        "linear_xent dx / dw bf16 disagree", err)
    rec = {}
    for name, site, key in (("linear_xent_fwd", ":1647", "loss"),
                            ("linear_xent_dx", ":1680", "dx"),
                            ("linear_xent_dw", ":1693", "dw")):
        rec[name] = dict(
            route="cuda",
            source="paddle_tpu_torch/kernels/csrc/linear_xent_bf16.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site,
            max_abs_err=err_abs[key], max_rel_err=err[key])
    if not times:
        return rec
    for tag, shape in (("wmt", LX_CASES[0]), ("bert", LX_BERT)):
        for name, t in _lxent_times(cs, dev, randn, g, *shape,
                                    slow=tag != "wmt").items():
            if tag == "wmt":
                rec[name].update(t)
            else:
                rec[name].setdefault("per_shape", {})["bert " + t.pop("shape")] = t
            print("%s bf16 %s: %s" % (name, tag, json.dumps(
                {k: v for k, v in t.items() if k.endswith("ms")})))
    return rec


def _lxent_times(cs, dev, randn, g, R, H, V, eps, slow):
    """The three bf16 kernels' times at one shape, beside the plain
    version and matmul + cross_entropy in bf16; `slow` shapes (ms a
    call) with CUDA events, the others by graph replays."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import linear_xent as lx

    bf = torch.bfloat16
    x = randn(R, H).to(bf)
    w = randn(H, V, scale=H ** -0.5).to(bf)
    lbl = torch.randint(0, V, (R,), generator=g, device=dev)
    dy = torch.rand(R, 1, generator=g, device=dev)
    _, lse = lx.linear_xent_fwd(x, w, lbl, eps)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

    def library_fwd():
        return F.cross_entropy(torch.matmul(x, w).float(), lbl,
                               label_smoothing=eps, reduction="none")

    def library_fwd_bwd():
        loss = F.cross_entropy(torch.matmul(xg, wg).float(), lbl,
                               label_smoothing=eps, reduction="none")
        return torch.autograd.grad(loss, (xg, wg), dy.reshape(-1))

    def timed(fn):
        return cs._events_ms(fn, reps=3) if slow else cs._time_ms(fn, inner=5)

    plain_grad = cs._events_ms(
        lambda: lx.linear_xent_grad_plain(x, w, lbl, lse, dy, eps))
    lib_fwd_bwd = cs._events_ms(library_fwd_bwd)
    row_bytes = 2 * (R * H + H * V) + 8 * R + 4 * 2 * R
    shape = "x [%d, %d], w [%d, %d] bf16, eps %.1f" % (R, H, H, V, eps)
    specs = (("linear_xent_fwd", lambda: lx.linear_xent_fwd(x, w, lbl, eps),
              lambda: lx.linear_xent_plain(x, w, lbl, eps), library_fwd,
              row_bytes, 2 * R * H * V),
             ("linear_xent_dx",
              lambda: lx.linear_xent_dx(x, w, lbl, lse, dy, eps), None, None,
              row_bytes + 2 * R * H, 4 * R * H * V),
             ("linear_xent_dw",
              lambda: lx.linear_xent_dw(x, w, lbl, lse, dy, eps), None, None,
              row_bytes + 2 * H * V, 4 * R * H * V))
    out = {}
    for name, kern, plain, lib, nbytes, flops in specs:
        out[name] = dict(
            shape=shape + ("" if plain else
                           "; plain_ms is the plain backward (dx and dw "
                           "together), library_ms matmul + cross_entropy "
                           "forward and backward"),
            ms=timed(kern),
            plain_ms=timed(plain) if plain else plain_grad,
            library_ms=timed(lib) if lib else lib_fwd_bwd,
            **_bound(cs, nbytes, flops))
    return out


# B12's bf16 forms (csrc/linear_xent_bf16.cu): (R, H, V_local, eps,
# vocab_total, shard): the vocab-parallel WMT step's slab (mp 2: x [4096,
# 512], w_local [512, 5000] of 10000; V_local % 8 == 0, 16-byte copies), a
# ragged R, an odd slab (element copies of w), an even slab that is no
# multiple of 8 (4-byte copies), H past one dx / dw pass of 512 (3 passes,
# H % 8 != 0: element copies of x), H 768, and a slab of 5 vocab tiles
# at R 4096 (a split without a tile before C14's repair)
VP_CASES = ((WMT_ROWS, WMT_D, WMT_VOCAB // 2, 0.1, WMT_VOCAB, 1),
            (WMT_ROWS - 1, WMT_D, WMT_VOCAB // 2, 0.1, WMT_VOCAB, 0),
            (300, WMT_D, 1007, 0.1, 3021, 2), (300, WMT_D, 1002, 0.0, 2004, 1),
            (200, 1100, 333, 0.1, 999, 1), (70, BERT_D, 1000, 0.0, 2000, 0),
            (WMT_ROWS, 128, 300, 0.1, 900, 1))


def _vp_inputs(randn, g, dev, r, h, v, vt, shard):
    """bf16 x and w_local, local labels (global ones over the whole vocab,
    rows 0-2 at -1, vocab_total and the slab's first column), the global
    row validity and a dy."""
    import torch

    bf = torch.bfloat16
    x = randn(r, h).to(bf)
    w = randn(h, v, scale=h ** -0.5).to(bf)
    lbl = torch.randint(0, vt, (r,), generator=g, device=dev)
    lbl[:3] = torch.tensor([-1, vt, shard * v], device=dev)
    valid = ((lbl >= 0) & (lbl < vt)).float()
    dy = torch.rand(r, 1, generator=g, device=dev)
    return x, w, lbl - shard * v, valid, dy


def check_sharded_linear_xent(cs, dev, randn, g, times=True):
    """B12's bf16 parts, dx and dw against their plain versions at
    VP_CASES, every rerun bit-equal: lse, gold and sum within 1e-5 of
    each one's largest magnitude (float32 sums of exact bf16 products in
    another order), dx and dw within 1e-2 of theirs (g is rounded to bf16
    before the product: a logit that differs in its last bits may round
    it the other way).  The lse handed to dx / dw is a global one (this
    shard's plus log 2).  Records named as the launch counters."""
    import torch

    slx = importlib.import_module(
        "paddle_tpu_torch.kernels.sharded_linear_xent")
    bf = torch.bfloat16
    err = {"parts": 0.0, "dx": 0.0, "dw": 0.0}
    err_abs = dict(err)

    def note(key, a, b):
        d = (a.float() - b.float()).abs().max().item()
        err_abs[key] = max(err_abs[key], d)
        err[key] = max(err[key], d / max(b.float().abs().max().item(), 1e-30))

    for r, h, v, e, vt, shard in VP_CASES:
        x, w, lbl, valid, dy = _vp_inputs(randn, g, dev, r, h, v, vt, shard)
        parts = slx.linear_xent_parts(x, w, lbl)
        assert all(t.dtype == torch.float32 and t.shape == (r, 1)
                   for t in parts)
        assert all(torch.equal(a, b) for a, b in zip(
            parts, slx.linear_xent_parts(x, w, lbl))), ("parts bf16 rerun",
                                                          r, h, v)
        p_parts = slx.linear_xent_parts_plain(x, w, lbl)
        for a, b in zip(parts, p_parts):
            note("parts", a, b)
        args = (x, w, lbl, valid, p_parts[0] + math.log(2.0), dy, e, vt)
        dx = slx.linear_xent_dx_sharded(*args)
        dw = slx.linear_xent_dw_sharded(*args)
        assert dx.dtype == dw.dtype == bf
        assert torch.equal(dx, slx.linear_xent_dx_sharded(*args)), (
            "dx sharded bf16 rerun", r, h, v)
        assert torch.equal(dw, slx.linear_xent_dw_sharded(*args)), (
            "dw sharded bf16 rerun", r, h, v)
        p_dx, p_dw = slx.linear_xent_grad_sharded_plain(*args)
        note("dx", dx, p_dx)
        note("dw", dw, p_dw)
        print("sharded_linear_xent bf16 [%d, %d] x [%d, %d] of %d eps %.1f: "
              "relative error so far %s" % (
                  r, h, h, v, vt, e,
                  {k: "%.3g" % v_ for k, v_ in err.items()}))
    assert err["parts"] <= 1e-5, ("linear_xent_parts bf16 disagrees", err)
    assert err["dx"] <= 1e-2 and err["dw"] <= 1e-2, (
        "linear_xent dx / dw sharded bf16 disagree", err)
    rec = {}
    for name, site, key in (("linear_xent_parts", ":1818", "parts"),
                            ("linear_xent_dx_sharded", ":1900", "dx"),
                            ("linear_xent_dw_sharded", ":1914", "dw")):
        rec[name] = dict(
            route="cuda",
            source="paddle_tpu_torch/kernels/csrc/linear_xent_bf16.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site,
            max_abs_err=err_abs[key], max_rel_err=err[key])
    if not times:
        return rec
    for name, t in _sharded_lxent_times(cs, dev, randn, g,
                                        *VP_CASES[0]).items():
        rec[name].update(t)
        print("%s bf16 wmt_vp: %s" % (name, json.dumps(
            {k: v for k, v in t.items() if k.endswith("ms")})))
    return rec


def _sharded_lxent_times(cs, dev, randn, g, R, H, V, eps, vocab_total,
                         shard):
    """The three bf16 forms' times at one shard's shape (graph replays),
    beside their plain versions (parts; the plain backward for dx and dw,
    CUDA events), the float32 forms on the same values widened, and the
    library: one bf16 matmul + logsumexp + gold gather + row sum for
    parts, the dense bf16 backward (logits, softmax, g, g @ w^T and
    x^T @ g) for dx and dw."""
    import torch

    slx = importlib.import_module(
        "paddle_tpu_torch.kernels.sharded_linear_xent")
    bf = torch.bfloat16
    x, w, lbl, valid, dy = _vp_inputs(randn, g, dev, R, H, V, vocab_total,
                                      shard)
    lse = slx.linear_xent_parts(x, w, lbl)[0] + math.log(2.0)
    args = (x, w, lbl, valid, lse, dy, eps, vocab_total)
    xf, wf = x.float(), w.float()
    args32 = (xf, wf) + args[2:]
    cols = torch.arange(V, device=dev)[None, :]
    inside = ((lbl >= 0) & (lbl < V))[:, None]
    gold_col = lbl.clamp(0, V - 1)[:, None]

    def library_parts():
        z = torch.matmul(x, w).float()
        return (torch.logsumexp(z, -1, keepdim=True),
                z.gather(1, gold_col) * inside, z.sum(-1, keepdim=True))

    def library_bwd():
        z = torch.matmul(x, w).float()
        p = torch.exp(z - lse)
        gg = valid[:, None] * (1.0 - eps) * (p - (cols == lbl[:, None]).float())
        if eps:
            gg = gg + eps * (p - 1.0 / vocab_total)
        gg = (gg * dy).to(bf)
        return gg @ w.t(), x.t() @ gg

    plain_grad = cs._events_ms(
        lambda: slx.linear_xent_grad_sharded_plain(*args))
    lib_bwd = cs._time_ms(library_bwd, inner=5)
    rows = 2 * (R * H + H * V) + 8 * R
    shape = "x [%d, %d], w_local [%d, %d] of %d bf16, eps %.1f" % (
        R, H, H, V, vocab_total, eps)
    specs = (
        ("linear_xent_parts", lambda: slx.linear_xent_parts(x, w, lbl),
         lambda: slx.linear_xent_parts(xf, wf, lbl),
         lambda: slx.linear_xent_parts_plain(x, w, lbl), library_parts,
         rows + 4 * 3 * R, 2 * R * H * V),
        ("linear_xent_dx_sharded", lambda: slx.linear_xent_dx_sharded(*args),
         lambda: slx.linear_xent_dx_sharded(*args32), None, None,
         rows + 4 * 3 * R + 2 * R * H, 4 * R * H * V),
        ("linear_xent_dw_sharded", lambda: slx.linear_xent_dw_sharded(*args),
         lambda: slx.linear_xent_dw_sharded(*args32), None, None,
         rows + 4 * 3 * R + 2 * H * V, 4 * R * H * V))
    out = {}
    for name, kern, f32, plain, lib, nbytes, flops in specs:
        out[name] = dict(
            shape=shape + ("" if plain else
                           "; plain_ms is the plain backward (dx and dw "
                           "together), library_ms the dense bf16 backward "
                           "(dx and dw together)"),
            ms=cs._time_ms(kern, inner=5),
            f32_ms=cs._time_ms(f32, inner=5),
            plain_ms=cs._time_ms(plain, inner=5) if plain else plain_grad,
            library_ms=cs._time_ms(lib, inner=5) if lib else lib_bwd,
            **_bound(cs, nbytes, flops))
    return out


# B4's bf16 forms as they were before B12's bf16 forms joined their file:
# scripts/linear_xent_bf16_before.cu, built into a library of its own
B4_BEFORE_SOURCE = os.path.join(ROOT, "scripts", "linear_xent_bf16_before.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
B4_BEFORE_SIGNATURES = {
    "ptt_linear_xent_fwd_bf16_before": (_P,) * 6 + (_I,) * 4 + (_F, _P),
    "ptt_linear_xent_dx_bf16_before": (_P,) * 6 + (_I,) * 3 + (_F, _P),
    "ptt_linear_xent_dw_bf16_before": (_P,) * 6 + (_I,) * 3 + (_F, _P),
}
_b4_before = {}


def _b4_before_path():
    from paddle_tpu_torch.kernels import build

    with open(B4_BEFORE_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            build.NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(build.BUILD_DIR, "liblxent_bf16_before_%s.so" % digest)


def start_b4_before_build():
    """Starts nvcc on the B4 before-library (None if it is built):
    returns (process, path)."""
    from paddle_tpu_torch.kernels import build

    path = _b4_before_path()
    if os.path.exists(path):
        return None, path
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared",
         "-o", path + ".tmp%d" % os.getpid(), B4_BEFORE_SOURCE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _b4_before["started"] = proc, path
    return proc, path


def b4_before_lib():
    """The loaded B4 before-library, built at first use (or by the
    build start_b4_before_build began)."""
    if "lib" in _b4_before:
        return _b4_before["lib"]
    proc, path = _b4_before.get("started") or start_b4_before_build()
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (B4_BEFORE_SOURCE,
                                                           out))
        os.replace(path + ".tmp%d" % os.getpid(), path)
    lib = ctypes.CDLL(path)
    for name, argtypes in B4_BEFORE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _I
    _b4_before["lib"] = lib
    return lib


def check_b4_unchanged(dev, randn, g):
    """B4's bf16 forward, dx and dw bit-equal to their forms before B12's
    bf16 forms joined the file, at WMT's and BERT's shapes: the check
    that the shared launchers, the row-validity pointer and the launched
    split count changed nothing there.  Returns the shapes held."""
    import torch

    from paddle_tpu_torch.kernels import linear_xent as lx

    lib = b4_before_lib()

    def call(name, *args):
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        rc = getattr(lib, name)(*cargs, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (name, rc)

    held = []
    for r, h, v, e in (LX_CASES[0], LX_BERT):
        x = randn(r, h).to(torch.bfloat16)
        w = randn(h, v, scale=h ** -0.5).to(torch.bfloat16)
        lbl = torch.randint(0, v, (r,), generator=g, device=dev)
        lbl[0], lbl[1] = -1, v
        dy = torch.rand(r, 1, generator=g, device=dev)
        loss, lse = lx.linear_xent_fwd(x, w, lbl, e)
        dx = lx.linear_xent_dx(x, w, lbl, lse, dy, e)
        dw = lx.linear_xent_dw(x, w, lbl, lse, dy, e)
        splits = lx.fwd_splits(r, v)
        b_loss, b_lse = (torch.empty_like(loss) for _ in range(2))
        part = torch.empty((splits, 4, r), dtype=torch.float32, device=dev)
        b_dx, b_dw = torch.empty_like(dx), torch.empty_like(dw)
        call("ptt_linear_xent_fwd_bf16_before", x, w, lbl, b_loss, b_lse,
             part, r, h, v, splits, float(e))
        call("ptt_linear_xent_dx_bf16_before", x, w, lbl, lse, dy, b_dx, r,
             h, v, float(e))
        call("ptt_linear_xent_dw_bf16_before", x, w, lbl, lse, dy, b_dw, r,
             h, v, float(e))
        torch.cuda.synchronize()
        for name, now, before in (("loss", loss, b_loss), ("lse", lse, b_lse),
                                  ("dx", dx, b_dx), ("dw", dw, b_dw)):
            assert torch.equal(now, before), (
                "B4's bf16 %s changed" % name, r, h, v)
        held.append("x [%d, %d], w [%d, %d], eps %.1f" % (r, h, h, v, e))
    print("B4's bf16 forward, dx and dw bit-equal to their forms before the "
          "B12 bf16 forms at %s" % held)
    return held


# flash attention (B3): (label, BH, Tq, Tk, d, causal, key bias, window,
# segment ids): the four paths' shapes, the packed form, d 128, a row
# whose keys all sit at NEG_INF
FLASH_CASES = (
    ("gpt2", 96, 1024, 1024, 64, True, None, 0, False),
    ("tinyllama", 64, 2048, 2048, 64, True, None, 0, False),
    ("bert", 384, 128, 128, 64, False, "padding", 0, False),
    ("wmt", 512, 64, 64, 64, False, "random", 0, False),
    ("wmt_causal", 512, 64, 64, 64, True, None, 0, False),
    ("cross", 64, 64, 96, 64, False, "padding", 0, False),
    ("packed", 96, 1024, 1024, 64, True, None, 256, True),
    ("d128", 16, 300, 300, 128, True, "random", 0, False),
    ("d128_bias", 16, 200, 333, 128, False, "padding", 0, False),
    ("masked_row", 8, 200, 200, 64, False, "masked", 0, False),
    ("ragged", 6, 77, 77, 64, True, "random", 40, False),
)
# matmul_swiglu (B6): (M, K, N): TinyLlama's FFN, then M and N off the
# tile (and K off a stage), the staging edges
SWIGLU_CASES = ((4096, 2048, 5632), (200, 1000, 333), (77, 512, 96),
                (4096, 256, 72), (130, 2048, 5632))
# the least share of a B3 or B6 bf16 output's elements equal to the plain
# version's.  A float32 value that differs by e relative from the plain
# one rounds the other way at about 2^8 e of the elements: the hi + lo
# pair keeps p and dS to ~2^-17, so a few tenths of a percent flip, up
# to ~1% in dq, whose sums cancel (each row's dS sums to zero); p or dS
# rounded once to bf16 (2^-9) moves ~40%.  One unit of the largest
# magnitude, the limit above, cannot tell these apart: a single flip
# near the top moves that far.
EQUAL_MIN = 0.98


def _one_unit(out, ref):
    """max |out - ref| over one bf16 unit in the last place of ref's
    largest magnitude (2^(e - 7) for a largest magnitude in [2^e,
    2^(e + 1)): a single rounding of a float32 value that differs in its
    last bits, which may go the other way at any element, moves an
    element by at most that), <= 1 within the limit; and the max
    |out - ref|."""
    d = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return d / (2.0 ** (math.floor(math.log2(top)) - 7) if top > 0
                else 1e-30), d


def _equal_share(out, ref):
    """The share of out's elements equal to ref's, bit for bit."""
    return (out == ref).float().mean().item()


def _rounded_once(fa, q, k, v, kb, lse, do, delta, causal, scale, window,
                  ids):
    """The control for EQUAL_MIN: the plain versions' arithmetic with p
    and dS each rounded once to bf16 before its second product, as a
    kernel feeding them to one bf16 product (no lo part) would; (o, dq,
    dk, dv) in bf16."""
    import torch

    bf = torch.bfloat16
    s = fa.attention_scores(q, k, kb, causal, scale, None, window, ids)
    p = torch.exp(s - lse[..., None])
    dof, vf = do.float(), v.float()
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, vf) - delta[..., None])
    p, ds = p.to(bf).float(), ds.to(bf).float()
    return (torch.einsum("bqk,bkd->bqd", p, vf).to(bf),
            (scale * torch.einsum("bqk,bkd->bqd", ds, k.float())).to(bf),
            (scale * torch.einsum("bqk,bqd->bkd", ds, q.float())).to(bf),
            torch.einsum("bqk,bqd->bkd", p, dof).to(bf))


def _flash_inputs(randn, g, bh, tq, tk, d, bias, window, seg):
    """bf16 q, k, v, dO, a float32 key bias of the asked kind and int32
    segment ids."""
    import torch

    bf = torch.bfloat16
    q, do = randn(bh, tq, d).to(bf), randn(bh, tq, d).to(bf)
    k, v = randn(bh, tk, d).to(bf), randn(bh, tk, d).to(bf)
    kb = None
    if bias == "random":
        kb = randn(bh, tk)
    elif bias in ("padding", "masked"):
        keep = torch.randint(tk // 2, tk + 1, (bh, 1), generator=g,
                             device=q.device)
        kb = torch.where(torch.arange(tk, device=q.device)[None] < keep,
                         torch.zeros((), device=q.device),
                         torch.full((), -1e9, device=q.device))
        if bias == "masked":
            kb[0] = -1e30  # every key of row 0 at NEG_INF
    ids = None
    if seg:
        cuts = torch.sort(torch.randint(1, tq, (bh, 6), generator=g,
                                        device=q.device), dim=1)[0]
        ids = (torch.arange(tq, device=q.device)[None, None]
               >= cuts[:, :, None]).sum(1).to(torch.int32)
    return q, k, v, do, kb, ids


def check_flash_attention(cs, dev, randn, g, times=True):
    """B3's bf16 forward, dq and dk/dv against the plain versions at
    FLASH_CASES, each rerun bit-equal, each output within one unit of its
    largest magnitude and equal to the plain version in EQUAL_MIN of its
    elements; at the first case, the p-rounded-once control
    (_rounded_once) must fall below EQUAL_MIN; {name: record}."""
    import torch

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

    err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    err_abs, lse_err, dkb_err = dict(err), 0.0, 0.0
    equal = {"fwd": 1.0, "dq": 1.0, "dkv": 1.0}
    control = None
    for label, bh, tq, tk, d, causal, bias, window, seg in FLASH_CASES:
        q, k, v, do, kb, ids = _flash_inputs(randn, g, bh, tq, tk, d, bias,
                                             window, seg)
        scale = d ** -0.5
        forms = dict(window=window, seg=ids)
        o, lse = fa.flash_attention_fwd(q, k, v, kb, causal, scale, **forms)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        p_o, p_lse = fa.flash_attention_plain(q, k, v, kb, causal, scale,
                                              None, window, ids)
        delta = fa._delta(o, do)
        dq = fa.flash_attention_dq(q, k, v, kb, lse, do, delta, causal, scale,
                                   **forms)
        dk, dv, dkb = fa.flash_attention_dkv(q, k, v, kb, lse, do, delta,
                                             causal, scale, **forms)
        assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
        p_dq, p_dk, p_dv, p_dkb = fa.flash_attention_grad_plain(
            q, k, v, kb, lse, do, delta, causal, scale, None, window, ids)
        again = fa.flash_attention_fwd(q, k, v, kb, causal, scale, **forms)
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1]), (
            "flash_attention_fwd bf16 rerun", label)
        assert torch.equal(dq, fa.flash_attention_dq(
            q, k, v, kb, lse, do, delta, causal, scale, **forms)), (
            "flash_attention_dq bf16 rerun", label)
        again = fa.flash_attention_dkv(q, k, v, kb, lse, do, delta, causal,
                                       scale, **forms)
        assert torch.equal(dk, again[0]) and torch.equal(dv, again[1]), (
            "flash_attention_dkv bf16 rerun", label)
        for key, pairs in (("fwd", ((o, p_o),)), ("dq", ((dq, p_dq),)),
                           ("dkv", ((dk, p_dk), (dv, p_dv)))):
            for got, want in pairs:
                u, a = _one_unit(got, want)
                err[key], err_abs[key] = max(err[key], u), max(err_abs[key], a)
                equal[key] = min(equal[key], _equal_share(got, want))
        if control is None:
            ctl = _rounded_once(fa, q, k, v, kb, p_lse, do, delta, causal,
                                scale, window, ids)
            control = dict(zip(("fwd", "dq", "dk", "dv"), (
                _equal_share(a, b) for a, b in zip(ctl, (p_o, p_dq, p_dk,
                                                         p_dv)))))
            print("flash attention bf16 %s: the p-rounded-once control "
                  "equals the plain version in %s of its elements" % (
                      label, {k_: "%.4f" % v_ for k_, v_ in control.items()}))
            del ctl
        lse_err = max(lse_err, ((lse - p_lse).abs()
                                / p_lse.abs().clamp_min(1.0)).max().item())
        if kb is not None:
            dkb_err = max(dkb_err, (dkb - p_dkb).abs().max().item()
                          / max(p_dkb.abs().max().item(), 1e-30))
            if bias == "masked":
                assert float(dq[0].float().abs().max()) == 0.0, label
        print("flash attention bf16 %s [%d, %d / %d, %d]: units so far %s, "
              "equal shares so far %s, lse %.3g, dkbias %.3g" % (
                  label, bh, tq, tk, d,
                  {k_: "%.3g" % v_ for k_, v_ in err.items()},
                  {k_: "%.5f" % v_ for k_, v_ in equal.items()}, lse_err,
                  dkb_err))
        del q, k, v, do, o, dq, dk, dv, p_o, p_dq, p_dk, p_dv
        torch.cuda.empty_cache()
    assert max(err.values()) <= 1.0, ("flash attention bf16 disagrees", err)
    assert min(equal.values()) >= EQUAL_MIN, (
        "flash attention bf16 departs from the plain version", equal)
    assert max(control.values()) < EQUAL_MIN, (
        "the p-rounded-once control passes EQUAL_MIN", control)
    assert lse_err <= 1e-5 and dkb_err <= 1e-4, (
        "flash attention bf16 lse / dkbias disagree", lse_err, dkb_err)
    rec = {}
    for key, site in (("fwd", ":279"), ("dq", ":447"), ("dkv", ":471")):
        rec["flash_attention_%s_bf16" % key] = dict(
            route="cuda",
            source="paddle_tpu_torch/kernels/csrc/flash_attention_bf16.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site,
            max_abs_err=err_abs[key], bf16_units=err[key],
            equal_share=equal[key], control_equal_share=control,
            max_lse_err=lse_err, dkbias_err=dkb_err)
    if not times:
        return rec
    for c in FLASH_CASES[:5] + FLASH_CASES[6:7]:
        for name, t in _flash_times(cs, randn, g, *c).items():
            r = rec[name + "_bf16"]
            if c[0] == "gpt2":
                r.update(t)
            else:
                r.setdefault("per_shape", {})[c[0]] = t
            print("%s bf16 %s: %s" % (name, c[0], json.dumps(
                {k_: v_ for k_, v_ in t.items() if k_.endswith("ms")})))
    return rec


def _flash_times(cs, randn, g, label, bh, tq, tk, d, causal, bias, window,
                 seg):
    """The three bf16 kernels' times at one shape beside the plain
    version and scaled_dot_product_attention in bf16 with the same mask
    (forward; forward and backward for dq and dk/dv), given [1, BH, T, d]
    so that its fused backends may take it.  The bound counts
    the visible pairs (the kernels skip the tiles outside the causal band
    and the window, not those of other segments) at bf16's rate."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

    q, k, v, do, kb, ids = _flash_inputs(randn, g, bh, tq, tk, d, bias,
                                         window, seg)
    scale = d ** -0.5
    forms = dict(window=window, seg=ids)
    mask = None if kb is None else kb[:, None, :].to(torch.bfloat16)
    if window or ids is not None:
        vis = cs._visible(tq, causal, window, ids, q.device)
        mask = torch.where(vis, torch.zeros((), device=q.device),
                           torch.full((), float("-inf"), device=q.device)
                           ).to(torch.bfloat16)
        pairs = int(vis.sum()) * (bh if vis.shape[0] == 1 else 1)
    else:
        pairs = bh * (tq * (tq + 1) // 2 if causal else tq * tk)
    o, lse = fa.flash_attention_fwd(q, k, v, kb, causal, scale, **forms)
    delta = fa._delta(o, do)
    qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))

    def library(q_, k_, v_):
        # [1, BH, T, d]: the fused backends take 4-D operands only
        return F.scaled_dot_product_attention(
            q_[None], k_[None], v_[None],
            attn_mask=None if mask is None else mask[None],
            is_causal=causal and mask is None, scale=scale)[0]

    def library_fwd_bwd():
        return torch.autograd.grad(library(qg, kg, vg), (qg, kg, vg), do)

    plain_grad = cs._events_ms(lambda: fa.flash_attention_grad_plain(
        q, k, v, kb, lse, do, delta, causal, scale, None, window, ids))
    lib_fwd_bwd = cs._events_ms(library_fwd_bwd)
    qrow, krow = 2 * bh * tq * d, 2 * bh * tk * d  # bytes of a bf16 operand
    extra = (0 if kb is None else 4 * bh * tk) + (0 if ids is None
                                                 else 4 * bh * tk)
    specs = (
        ("flash_attention_fwd",
         lambda: fa.flash_attention_fwd(q, k, v, kb, causal, scale, **forms),
         lambda: fa.flash_attention_plain(q, k, v, kb, causal, scale, None,
                                          window, ids),
         lambda: library(q, k, v),
         2 * qrow + 2 * krow + 4 * bh * tq + extra, 4 * pairs * d),
        ("flash_attention_dq",
         lambda: fa.flash_attention_dq(q, k, v, kb, lse, do, delta, causal,
                                       scale, **forms), None, None,
         3 * qrow + 2 * krow + 8 * bh * tq + extra, 6 * pairs * d),
        ("flash_attention_dkv",
         lambda: fa.flash_attention_dkv(q, k, v, kb, lse, do, delta, causal,
                                        scale, **forms), None, None,
         2 * qrow + 4 * krow + 8 * bh * tq + extra
         + (0 if kb is None else 4 * bh * tk), 8 * pairs * d),
    )
    out = {}
    for name, kern, plain, lib, nbytes, flops in specs:
        out[name] = dict(
            shape="q [%d, %d, %d], k, v [%d, %d, %d] bf16, %s%s%s%s" % (
                bh, tq, d, bh, tk, d, "causal" if causal else "not causal",
                "" if kb is None else ", float32 key bias",
                ", window %d" % window if window else "",
                ", segment ids" if ids is not None else "")
            + ("" if plain else "; plain_ms is the plain backward (dq, dk "
               "and dv together), library_ms scaled_dot_product_attention "
               "forward and backward"),
            ms=cs._time_ms(kern, reps=5, inner=5),
            plain_ms=cs._time_ms(plain, reps=5, inner=5) if plain
            else plain_grad,
            library_ms=cs._time_ms(lib, reps=5, inner=5) if lib
            else lib_fwd_bwd,
            **_bound(cs, nbytes, flops))
    return out


def check_matmul_swiglu(cs, dev, randn, times=True):
    """B6's bf16 form against matmul_swiglu_plain at SWIGLU_CASES, each
    rerun bit-equal; its record."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import matmul_epilogue as me
    from paddle_tpu_torch.kernels import matmul_swiglu, matmul_swiglu_plain

    bf = torch.bfloat16
    worst, err, equal = 0.0, 0.0, 1.0
    for m, k, n in SWIGLU_CASES:
        x = randn(m, k).to(bf)
        wg, wu = (randn(k, n, scale=k ** -0.5).to(bf) for _ in range(2))
        out = matmul_swiglu(x, wg, wu)
        assert out.dtype == bf and out.shape == (m, n)
        want = matmul_swiglu_plain(x, wg, wu)
        u, a = _one_unit(out, want)
        worst, err = max(worst, u), max(err, a)
        equal = min(equal, _equal_share(out, want))
        assert torch.equal(out, matmul_swiglu(x, wg, wu)), (
            "matmul_swiglu bf16 rerun", m, k, n)
        print("matmul_swiglu bf16 [%d, %d] @ [%d, %d]: plan %s, units %.3g, "
              "equal share %.5f" % (m, k, k, n, tuple(me.mm_plan(
                  m, n, k, gated=True, bf16=True)), worst, equal))
    assert worst <= 1.0, ("matmul_swiglu bf16 disagrees", worst)
    assert equal >= EQUAL_MIN, ("matmul_swiglu bf16 departs from the plain "
                                "version", equal)
    rec = dict(route="cuda",
               source="paddle_tpu_torch/kernels/csrc/matmul_bias_act.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:1302",
               max_abs_err=err, bf16_units=worst, equal_share=equal)
    if not times:
        return rec
    m, k, n = SWIGLU_CASES[0]
    x = randn(m, k).to(bf)
    wg, wu = (randn(k, n, scale=k ** -0.5).to(bf) for _ in range(2))
    rec.update(
        shape="TinyLlama FFN x [%d, %d] @ wg, wu [%d, %d], bf16" % (m, k, k,
                                                                   n),
        ms=cs._time_ms(lambda: matmul_swiglu(x, wg, wu)),
        plain_ms=cs._time_ms(lambda: matmul_swiglu_plain(x, wg, wu)),
        library_ms=cs._time_ms(
            lambda: F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)),
        plan=list(me.mm_plan(m, n, k, gated=True, bf16=True)),
        **_bound(cs, 2 * (m * k + 2 * k * n + m * n), 4 * m * k * n))
    print("matmul_swiglu bf16: %s" % json.dumps(
        {k_: v_ for k_, v_ in rec.items() if k_.endswith("ms")}))
    return rec


def check_bf16(cs, dev, randn, g, times=True):
    """{name: record} of the bf16 forms, named as their launch counters
    (matmul_bias_act_bf16, ...)."""
    import torch

    cs._print_ptxas("matmul_bias_act.cu", ("mm_tiled_bf16",))
    cs._print_ptxas("linear_xent_bf16.cu", ("lxent",))
    cs._print_ptxas("layer_norm.cu", ("bf16",))
    cs._print_ptxas("add_layer_norm.cu", ("bf16",))
    cs._print_ptxas("flash_attention_bf16.cu", ("bf16", "simt"))
    rec = {"matmul_swiglu_bf16": check_matmul_swiglu(cs, dev, randn, times),
           "matmul_bias_act_bf16": check_matmul(cs, dev, randn, times),
           "fused_layer_norm_bf16": check_layer_norm(cs, dev, randn, times),
           "fused_add_layer_norm_bf16": check_add_layer_norm(cs, dev, randn,
                                                             times)}
    for name, r in check_linear_xent(cs, dev, randn, g, times).items():
        rec[name + "_bf16"] = r
    for name, r in check_sharded_linear_xent(cs, dev, randn, g,
                                             times).items():
        rec[name + "_bf16"] = r
    check_b4_unchanged(dev, randn, g)
    rec.update(check_flash_attention(cs, dev, randn, g, times))
    torch.cuda.synchronize()
    return rec


def main():
    import torch

    if not torch.cuda.is_available():
        print("bf16_kernels_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build

    dev, smi = cs.card_setup()
    start_b4_before_build()
    build.load()
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rec = check_bf16(cs, dev, randn, g, times="--checks-only" not in sys.argv)
    print(smi)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
