#!/usr/bin/env python3
"""Holds the bf16 forms of four kernels against their plain versions on
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
  (forward; forward and backward for dx and dw).

Each form first meets its plain version at the path shapes and at the
edges of its staging (K, N, H or V not a multiple of 8: element loads in
place of 16-byte copies; ragged M, R and V; K slices; H past one pass of
dx / dw; labels -1 and V), every rerun bit-equal.  Limits: a bf16
output within one bf16 unit in the last place of the plain version
(|d| <= 2^-7 |plain| + 1e-5 max |plain|: both round a float32 value
that differs only in the order of its sums); B4's loss and lse
(float32) within 1e-5 of the largest magnitude; its dx and dw within
1e-2 of the largest magnitude (g is rounded to bf16 before the product,
and a float32 logit that differs in its last bits may round g the other
way).  Times are chip_smoke's (CUDA graph replays, the median of 5;
B4 at BERT's shape and the plain backward CUDA events); bounds are the larger of bytes over 3.35 TB/s and FLOPs over bf16's
dense tensor-core rate, 989 TFLOP/s.

    python3 scripts/bf16_kernels_check.py [--checks-only]

chip_smoke.py's kernel phase calls check_bf16(); its records are the
bf16 forms' entries of the kernels line.
"""

import json
import os
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
# H % 8 != 0 (element loads of x), two and three dx / dw passes
LX_CASES = ((WMT_ROWS, WMT_D, WMT_VOCAB, 0.1), (100, 96, 333, 0.0),
            (64, 100, 1000, 0.1), (300, 768, 1000, 0.0),
            (70, 1100, 301, 0.1), (8191, 512, 777, 0.1), (300, 64, 1002, 0.1))
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


def check_bf16(cs, dev, randn, g, times=True):
    """{name: record} of the bf16 forms, named as their launch counters
    (matmul_bias_act_bf16, ...)."""
    import torch

    cs._print_ptxas("matmul_bias_act.cu", ("mm_tiled_bf16",))
    cs._print_ptxas("linear_xent_bf16.cu", ("lxent",))
    cs._print_ptxas("layer_norm.cu", ("bf16",))
    cs._print_ptxas("add_layer_norm.cu", ("bf16",))
    rec = {"matmul_bias_act_bf16": check_matmul(cs, dev, randn, times),
           "fused_layer_norm_bf16": check_layer_norm(cs, dev, randn, times),
           "fused_add_layer_norm_bf16": check_add_layer_norm(cs, dev, randn,
                                                             times)}
    for name, r in check_linear_xent(cs, dev, randn, g, times).items():
        rec[name + "_bf16"] = r
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
