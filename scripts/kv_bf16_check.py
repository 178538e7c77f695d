#!/usr/bin/env python3
"""Holds the bf16-KV forms of the three KV-cache readers against their
plain versions on the card, and times them at the decode and serving
paths' shapes (cache_dtype="bfloat16": float32 q, bf16 k and v):

- the few-row forward (B3d, csrc/flash_attention_rows.cu's
  rows_kernel<D, TQ, bf16>): GPT-2's one-token step, q [48, 1, 64] over
  k/v [48, 1024, 64], and TinyLlama's GQA fold, q [8, 8, 64] over
  [8, 2048, 64], each with decode_pos_mask's key bias; the plan's edges
  (Tq 3 and 8, Tk off the slice, below one slice, 16 slices, head dim
  128 at the bf16 form's 256-key slices) with a row all at NEG_INF and
  a row at -1e9;
- the piece's forward (B9, csrc/flash_attention.cu's tc_fwd_kernel<bf16>
  and the SIMT form's simt_fwd_kernel<128, float, bf16>): GPT-2's
  chunked prefill, q [48, 64, 64] over [48, 1024, 64] at qoff 0, 192 and
  960, the speculative verify's 4-row chunk, a ragged chunk and head
  dim 128;
- the qvec forward (B8, csrc/flash_attention_qvec.cu's
  qvec_kernel<D, bf16>): the GPT-2 serving step, q [96, 16, 64] over
  [96, 1024, 64], and the TinyLlama-width step, q [256, 16, 64] over
  [256, 2048, 64], at full caches (every row's base Tk - Tq) and at the
  pools' mixed slot bases, head dim 128 over three slices, and Tq 20.

Each form first meets its plain version (flash_attention_plain /
flash_attention_piece_plain / flash_attention_qvec_plain on the same
float32 q and bf16 k, v, which widen k and v): within 1e-5 absolute on
o, the float32 forms' limit, and on the lse relative to max(1, |lse|);
its reruns are bit-equal, a serving row run alone is bit-equal to its
row in the batch, and its output is bit-equal to the float32 kernel's
on the widened cache (the design: a bf16 value widens exactly, and in
TF32 too, so every product and sum is the float32 form's).

Times are chip_smoke's (CUDA graph replays, the median of 5).  Bounds
are the larger of the bytes over 3.35 TB/s (q, o, the key bias and the
lse at 4 bytes, the keys and values each row reads at 2) and the FLOPs
over FP32's 67 TFLOP/s (the few-row and qvec forms, as chip_smoke
bounds their float32 forms) or 3xTF32's 165 TFLOP/s (B9's tensor-core
form).  The library time is scaled_dot_product_attention over k and v
widened by .float() with the widening inside the timed call
(library_ms); beside it, SDPA in bf16 with q rounded to bf16
(library_bf16q_ms), which computes a different function.

With --legs it then runs the bf16-cache paths alone, as chip_smoke.py
runs them: the GPT-2 small engine on the 24-request churn trace, the
speculative prefix leg, GPT-2 small's cached decoding (greedy chunked and
one-token, beam 2) and the TinyLlama-width engine, each over bf16 caches.

    python3 scripts/kv_bf16_check.py [--checks-only] [--legs]
    python3 scripts/kv_bf16_check.py --f32-times [--root TREE]

--f32-times times the float32 forms of B3d, B9, B8 and B3's tile
forward from the tree at TREE (default this one): the same forms from
two trees compared in one call, in turns.

chip_smoke.py's kernel phase calls check_kv_bf16(); its records are the
bf16-KV forms' entries of the kernels line.  Its bf16-KV legs call
serve_kv16, serve_spec_prefix_kv16 and decode_kv16.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LIMIT = 1e-5  # the float32 forms' limit on o, absolute


def _lse_err(lse, p_lse):
    return ((lse - p_lse).abs() / p_lse.abs().clamp_min(1.0)).max().item()


def _kv(randn, bh, tk, d):
    """bf16 k and v [BH, Tk, d], as a bf16 cache holds them."""
    import torch

    return (randn(bh, tk, d).to(torch.bfloat16),
            randn(bh, tk, d).to(torch.bfloat16))


def _library(q, k, v, mask, scale):
    """SDPA over the widened cache (the widening timed), and SDPA in bf16
    with q rounded (a different function)."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    wide = (lambda: F.scaled_dot_product_attention(
        q, k.float(), v.float(), attn_mask=mask, scale=scale))
    qb = q.to(bf)
    mb = mask.to(bf) if mask is not None and mask.is_floating_point() else mask
    half = (lambda: F.scaled_dot_product_attention(qb, k, v, attn_mask=mb,
                                                   scale=scale))
    return wide, half


def _times(cs, kern, plain, wide, half, nbytes, flops, tensor_cores=False):
    return dict(ms=cs._time_ms(kern), plain_ms=cs._time_ms(plain),
                library_ms=cs._time_ms(wide),
                library_bf16q_ms=cs._time_ms(half),
                **cs._bounds(nbytes, flops, tensor_cores))


def check_rows(cs, dev, randn, times=True):
    """B3d's bf16-KV form: see the module docstring."""
    import torch

    from paddle_tpu_torch.kernels import (flash_attention_fwd_rows,
                                          flash_attention_plain)
    from paddle_tpu_torch.kernels.flash_attention import NEG_INF, rows_plan

    cs._print_ptxas("flash_attention_rows.cu", ("rows_kernel",))
    err = lse_err = 0.0
    d64 = cs.GPT2_D // cs.GPT2_HEADS
    gpt2 = (cs.DECODE_BATCH * cs.GPT2_HEADS, 1, cs.T_MAX, d64,
            cs.DECODE_PROMPT + cs.DECODE_NEW - 1)
    fold = (cs.LLAMA_DECODE_BATCH * 4, cs.LLAMA_HEADS // 4, cs.LLAMA_LEN,
            cs.LLAMA_D // cs.LLAMA_HEADS,
            cs.LLAMA_DECODE_PROMPT + cs.LLAMA_DECODE_NEW - 1)
    for bh, tq, tk, d in ((3, 1, 1000, 64), (5, 3, 300, 64), (2, 8, 40, 64),
                          (6, 2, 4000, 64), (3, 8, 1000, 128),
                          (2, 4, 4000, 128), (1, 5, 129, 128), gpt2[:4],
                          fold[:4]):
        q = randn(bh, tq, d)
        k, v = _kv(randn, bh, tk, d)
        kb = randn(bh, tk)
        kb[0] = NEG_INF
        kb[-1, :tk // 2] = -1e9
        kb[-1, -3:] = -1e9
        for bias in (kb, None):
            o, lse = flash_attention_fwd_rows(q, k, v, bias, d ** -0.5)
            p_o, p_lse = flash_attention_plain(q, k, v, bias, False,
                                               d ** -0.5)
            assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
            err = max(err, (o - p_o).abs().max().item())
            lse_err = max(lse_err, _lse_err(lse, p_lse))
            again = flash_attention_fwd_rows(q, k, v, bias, d ** -0.5)
            assert torch.equal(o, again[0]) and torch.equal(lse, again[1]), (
                "few-row bf16-KV rerun differs", bh, tq, tk, d)
            f32 = flash_attention_fwd_rows(q, k.float(), v.float(), bias,
                                           d ** -0.5)
            if rows_plan(tk, d, torch.bfloat16) == rows_plan(tk, d):
                # (at d 128 the bf16-KV form's slices are longer)
                assert torch.equal(o, f32[0]) and torch.equal(lse, f32[1]), (
                    "few-row bf16-KV differs from the float32 form on the "
                    "widened cache", bh, tq, tk, d)
        print("  rows bf16-KV q [%d, %d, %d] k/v [%d, %d, %d]: plan %s" % (
            bh, tq, d, bh, tk, d, list(rows_plan(tk, d, torch.bfloat16))))
    assert err <= LIMIT and lse_err <= LIMIT, (
        "few-row bf16-KV forward disagrees", err, lse_err)
    rec = dict(route="cuda",
               source="paddle_tpu_torch/kernels/csrc/flash_attention_rows.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:279",
               max_abs_err=err, max_lse_err=lse_err)
    shapes = [("gpt2 decode",) + gpt2, ("llama decode (GQA fold)",) + fold]
    per = {}
    for tag, bh, tq, tk, d, pos in shapes:
        shape = "q [%d, %d, %d] f32, k/v [%d, %d, %d] bf16, key bias to %d" % (
            bh, tq, d, bh, tk, d, pos)
        t = dict(shape=shape, plan=list(rows_plan(tk, d, torch.bfloat16)))
        if times:
            q = randn(bh, tq, d)
            k, v = _kv(randn, bh, tk, d)
            kb = torch.zeros(bh, tk, device=dev)
            kb[:, pos + 1:] = -1e30
            s = d ** -0.5
            wide, half = _library(q, k, v, kb[:, None, :], s)
            t.update(_times(
                cs, lambda: flash_attention_fwd_rows(q, k, v, kb, s),
                lambda: flash_attention_plain(q, k, v, kb, False, s),
                wide, half,
                4 * (2 * bh * tq * d + bh * tk + bh * tq) + 2 * 2 * bh * tk * d,
                4 * bh * tq * tk * d))
        per[tag] = t
    first = per.pop("gpt2 decode")
    rec.update(first)
    rec["per_shape"] = {"%s %s" % (k_, t.pop("shape")): t
                        for k_, t in per.items()}
    print("flash_attention_fwd_rows_kvbf16: %s" % json.dumps(rec))
    return {"flash_attention_fwd_rows_kvbf16": rec}


def check_piece(cs, dev, randn, times=True):
    """B9's bf16-KV forward: see the module docstring."""
    import torch

    from paddle_tpu_torch.kernels import (flash_attention_piece_fwd,
                                          flash_attention_piece_plain)

    cs._print_ptxas("flash_attention.cu", ("tc_fwd",))
    err = lse_err = 0.0
    d64 = cs.GPT2_D // cs.GPT2_HEADS
    pre_bh = cs.DECODE_BATCH * cs.GPT2_HEADS
    verify = (cs.SPEC_BATCH * cs.GPT2_HEADS, cs.SPEC_K, cs.T_MAX,
              (cs.SPEC_PROMPT + cs.SPEC_NEW - cs.SPEC_K,))
    for bh, tq, tk, d, qoffs in (
            (pre_bh, cs.DECODE_WIDTH, cs.T_MAX, d64, (0, 192, 960)),
            verify[:3] + (d64, verify[3]), (6, 37, 1000, 64, (500,)),
            (4, 40, 300, 128, (0, 100, 260))):
        q = randn(bh, tq, d)
        k, v = _kv(randn, bh, tk, d)
        for off in qoffs:
            qoff = torch.tensor([off], device=dev)
            o, lse = flash_attention_piece_fwd(q, k, v, True, d ** -0.5, qoff)
            p_o, p_lse = flash_attention_piece_plain(q, k, v, True, d ** -0.5,
                                                     qoff)
            assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
            err = max(err, (o - p_o).abs().max().item())
            lse_err = max(lse_err, _lse_err(lse, p_lse))
            again = flash_attention_piece_fwd(q, k, v, True, d ** -0.5, qoff)
            assert torch.equal(o, again[0]) and torch.equal(lse, again[1]), (
                "piece bf16-KV rerun differs", bh, tq, tk, d, off)
            f32 = flash_attention_piece_fwd(q, k.float(), v.float(), True,
                                            d ** -0.5, qoff)
            assert torch.equal(o, f32[0]) and torch.equal(lse, f32[1]), (
                "piece bf16-KV differs from the float32 form on the widened "
                "cache", bh, tq, tk, d, off)
    assert err <= LIMIT and lse_err <= LIMIT, (
        "piece bf16-KV forward disagrees", err, lse_err)
    rec = dict(route="cuda",
               source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:577",
               max_abs_err=err, max_lse_err=lse_err)
    per = {}
    for tag, (bh, tq, tk, off) in (
            ("gpt2 prefill", (pre_bh, cs.DECODE_WIDTH, cs.T_MAX, 192)),
            ("gpt2 speculative verify", verify[:3] + verify[3])):
        d = d64
        keys = bh * min(tk, off + tq)  # the keys the rows need
        pairs = bh * sum(min(tk, off + i + 1) for i in range(tq))
        shape = "q [%d, %d, %d] f32, k/v [%d, %d, %d] bf16, qoff %d" % (
            bh, tq, d, bh, tk, d, off)
        t = dict(shape=shape)
        if times:
            q = randn(bh, tq, d)
            k, v = _kv(randn, bh, tk, d)
            qoff = torch.tensor([off], device=dev)
            mask = (off + torch.arange(tq, device=dev)[:, None]
                    >= torch.arange(tk, device=dev)[None, :])
            s = d ** -0.5
            wide, half = _library(q, k, v, mask, s)
            t.update(_times(
                cs, lambda: flash_attention_piece_fwd(q, k, v, True, s, qoff),
                lambda: flash_attention_piece_plain(q, k, v, True, s, qoff),
                wide, half, 4 * (2 * bh * tq * d + bh * tq) + 2 * 2 * keys * d,
                4 * pairs * d, tensor_cores=True))
        per[tag] = t
    rec.update(per.pop("gpt2 prefill"))
    rec["per_shape"] = {"%s %s" % (k_, t.pop("shape")): t
                        for k_, t in per.items()}
    print("flash_attention_piece_fwd_kvbf16: %s" % json.dumps(rec))
    return {"flash_attention_piece_fwd_kvbf16": rec}


def check_qvec(cs, dev, randn, times=True):
    """B8's bf16-KV forward: see the module docstring."""
    import torch

    from paddle_tpu_torch.kernels import (flash_attention_qvec,
                                          flash_attention_qvec_plain)
    from paddle_tpu_torch.kernels.flash_attention import qvec_plan

    cs._print_ptxas("flash_attention_qvec.cu", ("qvec",))
    heads, dh, tq, tk = cs.GPT2_HEADS, 64, cs.WIDTH, cs.T_MAX
    slot_q = [0, 500, tk - tq, 37, 0, 250, 999, 1]
    llama_q = [0, 1000, cs.LLAMA_LEN - tq, 37, 0, 1500, 2000, 1]
    full = [tk - tq] * cs.N_SLOTS
    llama_full = [cs.LLAMA_LEN - tq] * cs.N_SLOTS
    err = 0.0
    for d, bases, n_tk, per, tq_ in (
            (dh, full, tk, heads, tq), (dh, slot_q, tk, heads, tq),
            (128, [0, 1100, 2100 - 4], 2100, 2, 4),
            (64, [0, 150, 300 - 20], 300, 2, 20), (64, [3, 0], 40, 2, 4),
            (dh, llama_full, cs.LLAMA_LEN, cs.LLAMA_HEADS, tq),
            (dh, llama_q, cs.LLAMA_LEN, cs.LLAMA_HEADS, tq)):
        bh = len(bases) * per
        q = randn(bh, tq_, d)
        k, v = _kv(randn, bh, n_tk, d)
        qs = torch.tensor(bases, device=dev).repeat_interleave(per)
        out = flash_attention_qvec(q, k, v, qs, d ** -0.5)
        ref = flash_attention_qvec_plain(q, k, v, qs, d ** -0.5)
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
        err = max(err, (out - ref).abs().max().item())
        for _ in range(2):
            assert torch.equal(out, flash_attention_qvec(q, k, v, qs,
                                                         d ** -0.5)), (
                "qvec bf16-KV rerun differs", bh, tq_, n_tk, d)
        row = bh // 2 + 1
        solo = flash_attention_qvec(q[row:row + 1], k[row:row + 1],
                                    v[row:row + 1], qs[row:row + 1],
                                    d ** -0.5)
        assert torch.equal(solo[0], out[row]), (
            "qvec bf16-KV: a row alone differs from its row in the batch")
        assert torch.equal(out, flash_attention_qvec(
            q, k.float(), v.float(), qs, d ** -0.5)), (
            "qvec bf16-KV differs from the float32 form on the widened cache",
            bh, tq_, n_tk, d)
        print("  qvec bf16-KV q [%d, %d, %d] k/v [%d, %d, %d]: plan %s" % (
            bh, tq_, d, bh, n_tk, d,
            list(qvec_plan(n_tk, d, kv_dtype=torch.bfloat16))))
    assert err <= LIMIT, ("qvec bf16-KV forward disagrees", err)
    rec = dict(route="cuda",
               source="paddle_tpu_torch/kernels/csrc/flash_attention_qvec.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:621",
               max_abs_err=err,
               plan=list(qvec_plan(tk, dh, kv_dtype=torch.bfloat16)))
    per_shape = {}
    for tag, bh, n_tk, bases in (
            ("gpt2 serve", cs.N_SLOTS * heads, tk, full),
            ("gpt2 pool bases", cs.N_SLOTS * heads, tk, slot_q),
            ("llama serve", cs.N_SLOTS * cs.LLAMA_HEADS, cs.LLAMA_LEN,
             llama_full),
            ("llama pool bases", cs.N_SLOTS * cs.LLAMA_HEADS, cs.LLAMA_LEN,
             llama_q)):
        shape = "q [%d, %d, %d] f32, k/v [%d, %d, %d] bf16, slot bases %s" % (
            bh, tq, dh, bh, n_tk, dh, bases)
        t = dict(shape=shape)
        if times:
            q = randn(bh, tq, dh)
            k, v = _kv(randn, bh, n_tk, dh)
            qs = torch.tensor(bases, device=dev).repeat_interleave(
                bh // len(bases))
            live = int(torch.clamp(qs + tq, max=n_tk).sum())
            mask = (qs[:, None, None]
                    + torch.arange(tq, device=dev)[None, :, None]
                    >= torch.arange(n_tk, device=dev)[None, None, :])
            s = dh ** -0.5
            wide, half = _library(q, k, v, mask, s)
            t.update(_times(
                cs, lambda: flash_attention_qvec(q, k, v, qs, s),
                lambda: flash_attention_qvec_plain(q, k, v, qs, s),
                wide, half, 4 * (2 * bh * tq * dh + bh) + 2 * 2 * live * dh,
                4 * tq * live * dh))
        per_shape[tag] = t
    rec.update(per_shape.pop("gpt2 serve"))
    rec["per_shape"] = {"%s %s" % (k_, t.pop("shape")): t
                        for k_, t in per_shape.items()}
    print("flash_attention_qvec_kvbf16: %s" % json.dumps(rec))
    return {"flash_attention_qvec_kvbf16": rec}


def check_kv_bf16(cs, dev, randn, times=True):
    """The three bf16-KV forms' records (chip_smoke's kernel phase)."""
    import torch

    rec = {}
    rec.update(check_rows(cs, dev, randn, times))
    rec.update(check_piece(cs, dev, randn, times))
    rec.update(check_qvec(cs, dev, randn, times))
    torch.cuda.synchronize()
    return rec


# ---------------------------------------------------------------------------
# the bf16-cache paths on the card (chip_smoke.py's bf16-KV legs)
# ---------------------------------------------------------------------------
KV16_NEW = 24  # new tokens of the bf16-cache greedy decodes
LOGIT_REL = 2.0 ** -7  # bf16-cache logits against float32-cache ones
KV16_BEAM_NEW = 12
# the speculative prefix leg: an 8-request prefix trace, outputs 16-32
KV16_PREFIX_REQUESTS = 8
# the attention kernels' float32 forms, none of which a bf16-cache path runs
F32_ATTENTION = ("flash_attention_fwd_rows", "flash_attention_piece_fwd",
                 "flash_attention_qvec", "flash_attention_fwd")


def profile_dir(cs):
    """Where the bf16-KV legs' profiles go: build/kv_bf16_profiles (ignored
    by git)."""
    return os.path.join(cs._build_dir(), "kv_bf16_profiles")


def profile_captured(cs, eng, scope, name):
    """The captured serving step's device busy time and idle share: a
    seeded 3-request trace through `eng` under torch.profiler, after one
    request outside the window (chip_smoke._profile_report's report; the
    eager mode is not profiled here, whose hundreds of torch calls a step
    cost the profiler more than the run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.serving import make_poisson_trace

    trace = make_poisson_trace(3, rate=0.5, prompt_len_range=(16, 384),
                               out_len_range=(16, 64),
                               vocab_size=eng.hp.vocab_size, seed=1)
    with ptt.scope_guard(scope):
        eng.run(trace[:1])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, stats = eng.run(trace)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return cs._profile_report(prof, wall_us, stats["steps"], name,
                              profile_dir(cs))


def _no_f32_attention(label, launches):
    assert not any(launches[n] for n in F32_ATTENTION), (
        "a float32 attention kernel ran on a bf16-cache path", label,
        {n: launches[n] for n in F32_ATTENTION})


def _all_bf16(scope, names):
    import torch

    for n in names:
        assert scope.find_var(n).dtype == torch.bfloat16, n


def serve_kv16(cs, label, hp, t_max, per_step, seed, f32_kv_bytes, name):
    """A serving path with bf16 KV caches: chip_smoke._serve_on_card with
    cache_dtype="bfloat16" (its checks: launches at `per_step` times the
    steps, every request OK, pooled == solo for a greedy and a sampled
    request, no capture across the churn, eager == captured logits bit
    for bit), profiled for its busy ms and idle share, with the bf16-KV
    qvec form at a launch a layer and step and no float32 attention
    launch; the pool bf16 and kv_pool_bytes half the float32 engine's
    `f32_kv_bytes`.  Returns (launches, eng, scope, the capture record)."""
    per_step = dict(per_step, flash_attention_qvec=0,
                    flash_attention_qvec_kvbf16=hp.n_layer)
    launches, eng, scope, cap, _ = cs._serve_on_card(
        label + ", bf16 KV caches", hp, t_max, per_step, seed,
        cache_dtype="bfloat16")
    cs._busy_idle(cap, {"captured": profile_captured(cs, eng, scope, name)})
    _no_f32_attention(label, launches)
    _all_bf16(scope, eng.cache_names)
    kv = eng.kv_pool_bytes(scope)
    assert 2 * kv["total_bytes"] == f32_kv_bytes, (kv, f32_kv_bytes)
    print("%s, bf16 KV caches: kv_pool_bytes %d (float32 engine %d, ratio "
          "%.3f); captured step p50 %.3f ms, busy %s ms, idle %s" % (
              label, kv["total_bytes"], f32_kv_bytes,
              kv["total_bytes"] / f32_kv_bytes, cap["captured_p50_ms"],
              cap["captured_busy_ms"], cap["captured_idle"]))
    cap["kv_pool_bytes"] = kv["total_bytes"]
    cap["kv_pool_bytes_f32"] = f32_kv_bytes
    return launches, eng, scope, cap


def _greedy_vs(label, what, got_logits, want_logits, got, want, start):
    """Step by step: each step's logits within LOGIT_REL of the largest
    magnitude of `want`'s, the greedy tokens equal wherever the top-2
    margin is clear of twice that, until the first near tie decided
    differently (the rows then diverge).  Returns (worst, steps, stopped
    at a near tie)."""
    import numpy as np

    worst, steps = 0.0, 0
    for i, (a, b) in enumerate(zip(got_logits, want_logits)):
        assert a.shape == b.shape and np.isfinite(a).all(), (label, what, i)
        err = float(np.abs(a - b).max() / np.abs(b).max())
        worst = max(worst, err)
        assert err <= LOGIT_REL, (label, what, i, err)
        steps += 1
        top2 = np.sort(b, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_REL * np.abs(b).max()
        ta, tb = got[:, start + i], want[:, start + i]
        assert (ta == tb)[clear].all(), (label, what, "tokens", i)
        if not (ta == tb).all():
            return worst, steps, True
    return worst, steps, False


def decode_kv16(cs, dev):
    """KV-cached decoding of GPT-2 small with bf16 caches at full width
    (chip_smoke's decode shape: batch 4, t_max 1024, 4 seeded prompts of
    200 tokens, chunks of 64): greedy with chunked prefill (B9's and
    B3d's bf16-KV forms), greedy with one-token prefill (B3d's only), and
    beam 2 over 2 prompts (the step and wide programs at batch 4, the
    bf16 reorder program every step).  Checks: every run's launches are
    its program's, the bf16-KV counters at a launch a layer and run, no
    float32 attention launch; the chunked greedy's logits within 2^-7 of
    the largest magnitude of a float32-cache run's from the same weights
    (another scope), step by step, tokens equal where the margin is
    clear; the one-token greedy within 2^-7 of the chunked one; beam
    ids and finite scores, a reorder before every step; eager ==
    captured logits bit for bit; the caches bf16.  Prints the one-token
    step's p50, decode tokens/s, the prefill's tokens/s, and the busy ms
    and idle share of 8 profiled one-token steps.  Returns (launch
    totals, the capture record)."""
    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import gpt2

    hp = gpt2.GPT2Config
    label = "GPT-2 small, bf16 KV caches"
    batch, p, width, t_max = (cs.DECODE_BATCH, cs.DECODE_PROMPT,
                              cs.DECODE_WIDTH, cs.T_MAX)
    new = KV16_NEW
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CUDAPlace(0))
        _, start, _, _ = gpt2.gpt2_logits_program(hp, seq_len=p + new)
        start.random_seed = 1236
        exe.run(start)
        weights = {n: scope.find_var(n) for n in scope.local_var_names()}
        progs = {}
        for dt in ("float32", "bfloat16"):
            step, cstart, _, fetch, names = gpt2.gpt2_decode_step_program(
                hp, batch=batch, t_max=t_max, cache_dtype=dt)
            wide, _, _, wfetch, _ = gpt2.gpt2_decode_step_program(
                hp, batch=batch, t_max=t_max, width=width, cache_dtype=dt)
            progs[dt] = (step, cstart, fetch, (wide, wfetch, width, t_max),
                         names)
        step, cstart, fetch, prefill, names = progs["bfloat16"]
        wide = prefill[0]
        prompts = np.random.RandomState(1236).randint(
            1, hp.vocab_size, (batch, p)).astype("int64")
        runs = cs._DecodeRuns(exe)
        last_c0 = cs._last_chunk_start(p, width, t_max)
        runs.keep[id(step)] = lambda lg, k: lg
        runs.keep[id(wide)] = lambda lg, k: lg[:, p - 1 - last_c0]
        # greedy with one-token prefill first: its runs make the step
        # program's captures; then two chunked prefills make the wide
        # program's, so the timed greedy below runs captured throughout
        one_token = gpt2.greedy_generate_cached(exe, step, cstart, fetch,
                                                prompts, new)
        one_logits = runs.kept[id(step)][p - 1:]  # from the prompt's last
        for _ in range(2):
            exe.run(cstart)
            gpt2.prefill_cached_chunked(exe, wide, prefill[1], prompts, width,
                                        t_max)
        n_wide = len(runs.times[id(wide)])
        chunked = gpt2.greedy_generate_cached(exe, step, cstart, fetch,
                                              prompts, new, prefill=prefill)
        n_chunks = len(runs.times[id(wide)]) - n_wide
        assert n_chunks == -(-p // width)
        prefill_s = sum(runs.times[id(wide)][n_wide:])
        step_times = list(runs.times[id(step)][-(new - 1):])
        # the last chunk's row at the prompt's last position, then each
        # step's
        chunked_logits = ([runs.kept[id(wide)][-1]]
                          + runs.kept[id(step)][-(new - 1):])
        _all_bf16(scope, names)
        one_err, one_steps, one_tie = _greedy_vs(
            label, "one-token vs chunked prefill", one_logits, chunked_logits,
            one_token, chunked, p)

        reorders = runs.feeds[("parents",)]
        n_before = len(runs.times[id(step)])
        ids, scores = gpt2.beam_generate_cached(
            exe, step, cstart, fetch, prompts[:batch // 2], KV16_BEAM_NEW,
            beam_size=2, prefill=prefill)
        beam_steps = len(runs.times[id(step)]) - n_before
        assert ids.shape == (batch // 2, p + KV16_BEAM_NEW), ids.shape
        assert np.isfinite(scores).all(), scores
        assert beam_steps == KV16_BEAM_NEW - 1, beam_steps
        assert runs.feeds[("parents",)] - reorders == beam_steps
        _all_bf16(scope, names)

    # the float32-cache run from the same weights, in a scope of its own
    scope32 = ptt.Scope()
    for n, w in weights.items():
        scope32.set(n, w)
    with ptt.scope_guard(scope32):
        exe32 = ptt.Executor(ptt.CUDAPlace(0))
        step32, cstart32, fetch32, prefill32, _ = progs["float32"]
        seen32 = []
        run32 = exe32.run

        def keeping(program=None, feed=None, fetch_list=None, **kw):
            out = run32(program, feed=feed, fetch_list=fetch_list, **kw)
            if program is step32:
                seen32.append(np.asarray(out[0]))
            elif program is prefill32[0]:
                seen32.append(np.asarray(out[0])[:, p - 1 - last_c0])
            return out

        exe32.run = keeping
        f32 = gpt2.greedy_generate_cached(exe32, step32, cstart32, fetch32,
                                          prompts, new, prefill=prefill32)
        exe32.close()
    f32_logits = seen32[n_chunks - 1:]  # the last chunk's, then each step's
    f32_err, f32_steps, f32_tie = _greedy_vs(
        label, "bf16 vs float32 caches", chunked_logits, f32_logits, chunked,
        f32, p)

    totals = runs.totals
    _no_f32_attention(label, totals)
    step_runs = len(runs.times[id(step)])
    assert totals["flash_attention_fwd_rows_kvbf16"] == step_runs * hp.n_layer
    assert totals["flash_attention_piece_fwd_kvbf16"] == (
        len(runs.times[id(wide)]) * hp.n_layer)
    step_p50 = cs._p50_ms(step_times)
    print("%s decode: batch %d, prompt %d; chunked prefill (width %d) %d "
          "chunks in %.1f ms (%.1f tokens/s); greedy %d new tokens, "
          "one-token step p50 %.3f ms, %.1f decode tokens/s; against the "
          "float32 caches %d steps' logits within %.3g of the largest "
          "magnitude (limit %.3g)%s; one-token prefill's %d steps within "
          "%.3g of the chunked%s; beam 2 over %d prompts: %d steps, each "
          "after a bf16 cache reorder, scores %s; launches B9 bf16-KV %d, "
          "B3d bf16-KV %d, float32 attention 0" % (
              label, batch, p, width, n_chunks, prefill_s * 1e3,
              batch * p / prefill_s, new, step_p50, batch * 1e3 / step_p50,
              f32_steps, f32_err, LOGIT_REL,
              ", then a near tie" if f32_tie else ", tokens equal",
              one_steps, one_err, ", then a near tie" if one_tie else "",
              batch // 2, beam_steps, scores.tolist(),
              totals["flash_attention_piece_fwd_kvbf16"],
              totals["flash_attention_fwd_rows_kvbf16"]))

    with ptt.scope_guard(scope):
        compiles = exe.compile_count
        cap = cs._decode_legs(
            label + " decode", step,
            lambda exe_: gpt2.greedy_generate_cached(
                exe_, step, cstart, fetch, prompts, cs.CAPTURE_NEW,
                prefill=prefill))
        reports = _profile_steps(cs, exe, step, cstart, fetch, chunked,
                                 p + new, t_max)
    cap.update(captured_p50_ms=step_p50, compile_count=compiles,
               decode_tokens_per_s=batch * 1e3 / step_p50,
               prefill_tokens_per_s=batch * p / prefill_s,
               max_logit_rel_vs_f32=f32_err)
    cs._busy_idle(cap, reports)
    print("%s decode: one-token step busy %s ms, idle %s captured; busy %s "
          "ms, idle %s eager" % (label, cap["captured_busy_ms"],
                                 cap["captured_idle"], cap["eager_busy_ms"],
                                 cap["eager_idle"]))
    exe.close()
    return totals, cs._capture_line(label + " decode", cap)


def _profile_steps(cs, exe, step, cstart, fetch, tokens, total, t_max):
    """8 one-token steps captured and 8 eager under torch.profiler: each
    mode's report (chip_smoke._profile_report)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    tok = tokens[:, -1:]
    reports = {}
    for mode, cached in (("captured", True), ("eager", False)):
        exe.run(cstart)
        exe.run(step, feed={"step_ids": tok, "pos": np.array(
            [total - 1], "int64")}, fetch_list=fetch, use_program_cache=cached)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(8):
                exe.run(step, feed={"step_ids": tok, "pos": np.array(
                    [min(total - 1 + i, t_max - 1)], "int64")},
                        fetch_list=fetch, use_program_cache=cached)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        reports[mode] = cs._profile_report(
            prof, wall_us, 8, "decode_kv16" + ("" if cached else "_eager"),
            profile_dir(cs))
    return reports


def serve_spec_prefix_kv16(cs, scope, f32_kv_bytes):
    """GPT-2 small's engine with bf16 caches, speculation and the prefix
    cache, over the serving path's weights (`scope`): an 8-request
    prefix trace (2 templates of PREFIX_LEN tokens, tails of 2-6, outputs
    of 16-32, half sampled, seed 3) through two engines: cold (no prefix,
    no draft) and registered with draft "self" (both templates stored,
    spec_k SPEC_K: the draft's pool and both prefix banks bf16 too).
    Each serves the trace's first 2 requests twice first (every program
    makes its captures), then the trace with the launch counts reset
    just before and read just after.  Checks: the launches are the
    programs' (the bf16-KV qvec form, no float32 attention); every
    request OK; the speculative prefix leg's greedy streams == the cold
    leg's bit for bit, prefix hits among them (a prefix hit == a cold
    prefill, greedy speculation == plain decode; its sampled streams
    take the keyed speculative rule); on that leg pooled == solo for a
    greedy and a sampled request, a 2-request trace eager == captured
    bit for bit, the pools bf16 and kv_pool_bytes half the float32
    engine's `f32_kv_bytes`, and its captured busy ms and idle share
    from a profile.  Returns (launch totals, the speculative leg's
    capture record)."""
    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import gpt2
    from paddle_tpu_torch.serving import ServingEngine, make_prefix_trace

    hp = gpt2.GPT2Config
    trace, templates = make_prefix_trace(
        KV16_PREFIX_REQUESTS, rate=0.5, n_prefixes=2, prefix_len=cs.PREFIX_LEN,
        tail_len_range=(2, 6), out_len_range=(16, 32),
        vocab_size=hp.vocab_size, reuse_fraction=0.9, sampled_fraction=0.5,
        seed=3)
    totals = {fn.__name__: 0 for fn in kernels.KERNELS}
    legs, cap = {}, None
    for leg, register, draft in (("cold", False, None),
                                 ("registered, self draft", True, "self")):
        with ptt.scope_guard(scope):
            exe = ptt.Executor(ptt.CUDAPlace(0))
            eng = ServingEngine(exe, hp, n_slots=cs.N_SLOTS, width=cs.WIDTH,
                                t_max=cs.T_MAX, cache_dtype="bfloat16",
                                draft=draft,
                                spec_k=cs.SPEC_K if draft else None,
                                prefix_rows=cs.PREFIX_ROWS if register else 0,
                                prefix_chunk=cs.WIDTH if register else None)
            rows = [eng.register_prefix(t) for t in templates if register]
            assert None not in rows and len(set(rows)) == len(rows), rows
            for _ in range(2):
                _, warm = eng.run(trace[:2])
            assert warm["prefix_hits"] >= register, warm
            log = cs._RunLog(exe)
            kernels.reset_launch_counts()
            results, stats = eng.run(trace)
            launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
            compiles = log.close()
            cs._spec_launch_check("bf16 prefix " + leg, launches, eng, stats)
            _no_f32_attention(leg, launches)
            assert launches["flash_attention_qvec_kvbf16"] > 0, leg
            for name, n in launches.items():
                totals[name] += n
            for r in trace:
                res = results[r.rid]
                assert res["status"] == "OK", (leg, r.rid, res["status"])
                assert res["tokens"].size == r.max_new_tokens, (leg, r.rid)
            kv = eng.kv_pool_bytes()
            assert 2 * kv["total_bytes"] == f32_kv_bytes, (leg, kv)
            names = list(eng.cache_names)
            if draft:
                names += list(eng.draft_cache_names)
            if register:
                names += ["pfx_" + n for n in names]
            _all_bf16(scope, names)
            if draft:
                for r in (next(r for r in trace if r.greedy),
                          next(r for r in trace if not r.greedy)):
                    toks, _ = eng.run_solo(r)
                    assert np.array_equal(toks, results[r.rid]["tokens"]), (
                        "pooled != solo", leg, r.rid)
                short = trace[:2]
                logits = cs._logits_legs(eng, exe.run, short)
                report = profile_captured(cs, eng, scope,
                                          "serving_spec_prefix_kv16")
                cap = {"eager_p50_ms": logits["eager"][1] * 1e3,
                       "captured_p50_ms": stats["step_s_p50"] * 1e3,
                       "replay_p50_ms": logits["captured"][1] * 1e3,
                       "compile_count": compiles,
                       "kv_pool_bytes": kv["total_bytes"],
                       "kv_pool_bytes_f32": f32_kv_bytes}
                cs._busy_idle(cap, {"captured": report})
            legs[leg] = dict(results=results, stats=stats, kv=kv)
            exe.close()
            del eng
            torch.cuda.empty_cache()
    cold = legs["cold"]["results"]
    spec = legs["registered, self draft"]
    for r in trace:
        if r.greedy:
            assert np.array_equal(spec["results"][r.rid]["tokens"],
                                  cold[r.rid]["tokens"]), (
                "bf16 caches: a prefix hit or speculation != cold", r.rid)
    for leg, got in legs.items():
        st = got["stats"]
        print("served GPT-2 small with bf16 KV caches and the prefix cache, "
              "%s: %d requests, %d prefill chunks, %d steps, %.1f tokens/s, "
              "step p50 %.3f ms; prefix hits %d, %d tokens reused; "
              "acceptance %.4f; kv_pool_bytes %d" % (
                  leg, len(trace), st["prefill_chunks"], st["steps"],
                  st["tokens_per_s"], st["step_s_p50"] * 1e3,
                  st["prefix_hits"], st["prefix_tokens_reused"],
                  st["accept_rate"], got["kv"]["total_bytes"]))
    hits = [r.rid for r in trace if r.greedy
            and spec["results"][r.rid]["prefix_len"]]
    assert hits, "no greedy request hit a prefix"
    print("bf16 caches: the speculative prefix leg's %d greedy streams == "
          "the cold leg's bit for bit (%d of them prefix hits: rids %s); "
          "speculative leg busy %s ms, idle %s" % (
              sum(r.greedy for r in trace), len(hits), hits,
              cap["captured_busy_ms"], cap["captured_idle"]))
    return totals, cs._capture_line(
        "GPT-2 small, bf16 KV, speculative prefix serving", cap)


def f32_times(root):
    """The float32 forms of the three KV-cache readers and B3's tile
    forward (whose sources are templated on the K/V type) timed at
    the paths' shapes, from the package under `root` (another tree, such
    as the parent commit's unpacked under build/, builds its own library
    there): {shape: ms}.  Run both trees in one call, in turns."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from paddle_tpu_torch.kernels import build, flash_attention_fwd
    from paddle_tpu_torch.kernels import flash_attention_fwd_rows
    from paddle_tpu_torch.kernels import flash_attention_piece_fwd
    from paddle_tpu_torch.kernels import flash_attention_qvec

    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    assert build.CSRC.startswith(os.path.abspath(root)), build.CSRC
    build.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    s = 0.125
    q, k, v = randn(96, 1024, 64), randn(96, 1024, 64), randn(96, 1024, 64)
    qp = randn(48, 64, 64)
    q1, kb = randn(48, 1, 64), torch.zeros(48, 1024, device=dev)
    kb[:, 256:] = -1e30
    qv = randn(96, 16, 64)
    qs = torch.full((96,), 1008, device=dev)
    off = torch.tensor([192], device=dev)
    return {
        "B3 tile forward 96x1024x64 causal": cs._time_ms(
            lambda: flash_attention_fwd(q, k, v, None, True, s)),
        "B9 forward 48x64x64 over 48x1024x64, qoff 192": cs._time_ms(
            lambda: flash_attention_piece_fwd(qp, k[:48], v[:48], True, s,
                                              off)),
        "B3d 48x1x64 over 48x1024x64, key bias to 255": cs._time_ms(
            lambda: flash_attention_fwd_rows(q1, k[:48], v[:48], kb, s)),
        "B8 96x16x64 over 96x1024x64, bases Tk - Tq": cs._time_ms(
            lambda: flash_attention_qvec(qv, k, v, qs, s))}


def main():
    import torch

    if not torch.cuda.is_available():
        print("kv_bf16_check: no CUDA device", file=sys.stderr)
        return 2
    if "--f32-times" in sys.argv:
        root = (sys.argv[sys.argv.index("--root") + 1]
                if "--root" in sys.argv else ROOT)
        print("float32 forms from %s: %s" % (root, json.dumps(f32_times(root))))
        return 0
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build

    dev, smi = cs.card_setup()
    build.load()
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rec = check_kv_bf16(cs, dev, randn, times="--checks-only" not in sys.argv)
    print(smi)
    print(json.dumps(rec))
    if "--legs" in sys.argv:
        legs(cs, dev)
    return 0


def legs(cs, dev):
    """The bf16-cache paths alone, as chip_smoke.py's bf16-KV legs run
    them; the float32 engines' pool bytes they are held against come
    from the pools' shapes here."""
    from paddle_tpu_torch.models import gpt2

    hp = gpt2.GPT2Config
    f32 = cs.N_SLOTS * 2 * hp.n_layer * hp.d_model * cs.T_MAX * 4
    _, eng, scope, _ = serve_kv16(cs, "GPT-2 small", hp, cs.T_MAX,
                                  cs._gpt2_serving_step(hp), 1234, f32,
                                  "serving_kv16")
    eng.exe.close()
    del eng
    serve_spec_prefix_kv16(cs, scope, f32)
    decode_kv16(cs, dev)
    llama = cs.tinyllama_config()
    f32_llama = (cs.N_SLOTS * 2 * llama.n_layer * llama.n_kv_head
                 * (llama.d_model // llama.n_head) * llama.n_ctx * 4)
    serve_kv16(cs, "TinyLlama-1.1B widths", llama, llama.n_ctx,
               cs._llama_serving_step(), 1235, f32_llama,
               "serving_llama_kv16")


if __name__ == "__main__":
    sys.exit(main())
