#!/usr/bin/env python3
"""On-card smoke run of paddle_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --profile  # also: where the serving and training
                                     # steps' time goes (chiprun_out/)

In order, it:

1. prints the card (nvidia-smi name and power limit) and the toolchain
   (torch, its CUDA, nvcc);
2. builds the hand-written kernels from paddle_tpu_torch/kernels/csrc;
3. holds each kernel against its plain PyTorch version on the card, at
   the serving, training and decode paths' shapes plus ragged ones (the
   softmax cross entropy at BERT's NSP [32, 2] and MLM-wide [4096,
   30522]; flash_attention_piece's forward at the chunked prefills'
   shapes and its backward, with an lse cotangent, at ring-like ones;
   flash_attention_qvec's backward at the serving shape; fused_lstm and
   fused_gru at the recurrent paths' shapes with ragged lengths), and
   times kernel, plain version and one PyTorch library call with CUDA
   events;
4. serves a seeded Poisson trace of 24 requests with GPT-2 small
   (random weights from a seed) through ServingEngine, with every
   kernel's launch count reset just before and read just after; checks
   every request finished OK with its full budget, a greedy and a
   sampled request equal their run_solo bit for bit, and the launch
   counts equal the per-step count times the engine's steps;
5. runs a narrow config through the engine on the card and on the CPU
   (plain path) with the same weights, in a pool of three slots and in
   one of one slot, and holds the logits of every step against each
   other;
6. with --profile, serves a short trace under torch.profiler and reports
   device busy time and idle share, torch calls, device time by kernel
   and host time by engine span (chiprun_out/profile_serving.json);
7. trains Transformer-base (the WMT program: 6+6 layers, d_model 512,
   vocab 10000, dropout and label smoothing 0.1, noam lr, Adam) on batch
   64 x 64 from seeded random weights: one warm-up step, 10 timed steps
   with every launch count reset just before and read just after and
   held to the count the program implies, then one step twice from the
   same saved state, bit for bit, and one step whose dropout_grad ops
   must redraw their forward ops' masks (with --profile, 3 more steps
   under the profiler, chiprun_out/profile_training.json);
8. trains a narrow WMT config 3 steps on the card and on the CPU plain
   path from the same weights and holds the losses to 1e-5 relative;
9. trains GPT-2 small (gpt2_lm_program: vocab 50257, d_model 768, 12
   layers, 12 heads, dropout 0.1, untied head, Adam) on batch 8 x 1024
   from seeded random weights: one warm-up step (its loss near ln
   50257), 10 timed steps with every launch count reset just before and
   read just after and held to the count the program implies, then one
   step twice from the same saved state, bit for bit, and one step whose
   dropout_grad ops must redraw their forward ops' masks (with
   --profile, 3 more steps under the profiler,
   chiprun_out/profile_training_gpt2.json);
10. trains a narrow GPT-2 (vocab 1000, d_model 256, 4 heads, 2 layers,
   seq 128, dropout 0) 3 steps on the card and on the CPU plain path from
   the same weights and holds the losses to 1e-5 relative;
11. serves the same 24-request trace with the modern-decoder GPT-2
   options at TinyLlama-1.1B's widths (vocab 32000, n_ctx 2048, d_model
   2048, 22 layers, 32 query and 4 KV heads, rotary positions, SwiGLU
   FFN 5632 wide; random weights from a seed; t_max 2048), with the same
   checks (matmul_swiglu 22 launches an engine step beside the GPT-2
   kernels), then a narrow modern config on the card and the CPU in a
   three-slot and a one-slot pool (with --profile:
   chiprun_out/profile_serving_llama.json);
12. trains that TinyLlama-width config (dropout 0, Adam) on batch 2 x
   2048: one warm-up step (its loss near ln 32000), 5 timed steps with
   the launch counts held to the program's, then one step twice from the
   same saved state, bit for bit (with --profile,
   chiprun_out/profile_training_llama.json); then a narrow modern config
   3 steps on the card and on the CPU, losses within 1e-5 relative;
13. pretrains BERT-base (bert_pretrain_program: vocab 30522, hidden 768,
   12 layers, 12 heads, dropout 0.1, fused attention with the
   key-padding bias, MLM over every position and NSP, Adam lr 1e-4) on
   batch 32 x 128 with ragged lengths: one warm-up step (its loss near
   ln 30522 + ln 2), 10 timed steps with the launch counts held to the
   program's (the softmax cross-entropy kernels under the NSP head
   included), the bit-equal repeat and the dropout masks (with
   --profile, chiprun_out/profile_training_bert.json); then a narrow
   BERT 3 steps on the card and on the CPU, the total, MLM and NSP
   losses within 1e-5 relative;
14. trains Transformer-base with hp.fused_attn (every attention on the
   flash kernels, causal and key-bias forms) 1 + 3 steps with the same
   checks, and a narrow fused_attn WMT config card vs CPU;
15. decodes GPT-2 small with the KV cache (gpt2_decode_step_program at
   batch 4, t_max 1024, one token and 64 wide; 4 seeded prompts of 200
   tokens): chunked prefill against one-token prefill (over a chunk and
   a ragged one), cached greedy (56 new tokens) against greedy_generate
   on gpt2_logits_program step by step over the first 16, seeded sampling (top-k 40, top-p 0.9) and beam 4 over 2 prompts
   (programs at batch 8, the cache reorder every step), every run's
   launches held to its program's (flash_attention_piece's forward 12
   per wide step, flash_attention's 12 per one-token step); prints the
   one-token step's p50 and decode tokens/s, the chunked prefill's
   tokens/s and the beam step's p50 (with --profile,
   chiprun_out/profile_decode.json); then a narrow GPT-2 decoded greedy,
   sampled and by beam on the card and on the CPU, tokens equal and
   logits within 1e-5 relative;
16. decodes at TinyLlama-1.1B's widths (t_max 2048, batch 2, prompts of
   256, chunks of 128, 32 new tokens, greedy) with the same checks (the
   GQA fold puts flash_attention at Tq 8 with a key bias; with
   --profile, chiprun_out/profile_decode_llama.json), and the narrow
   modern config card vs CPU;
17. trains the stacked dynamic LSTM (build_stacked_lstm_train at
   bench.py's setting: dict 10000, 64 tokens, emb and hidden 512, 3
   layers, 2 classes, Adam 1e-3) on batch 32 x 64: one warm-up step (its
   loss near ln 2), 5 timed steps with the launch counts held to the
   program's (fused_lstm 4 a step: layers 1 and 3, forward and grad;
   layer 2 is reversed, the reference's plain scan), the bit-equal
   repeat (with --profile, chiprun_out/profile_training_lstm.json); then
   the narrow LSTM of the CPU tests 3 steps on the card and the CPU;
18. trains the GRU seq2seq model (build_seq2seq_train at Paddle's
   benchmark machine_translation widths: 512, dictionaries 30000, Adam
   1e-3) on batch 32 x 50 the same way (its first loss near ln 30000;
   fused_gru 4 a step; chiprun_out/profile_training_seq2seq.json), and
   the narrow seq2seq card vs CPU;
19. beam-decodes with build_decode_step at those widths (beam 4 over 2
   sentences, 16 steps through BeamSearchDecoder; fused_gru at T 50 and
   at T 1 from H0 every step), prints the decode step's p50, and the
   narrow decode step card vs CPU (tokens equal, log-probs 1e-5);
20. trains Transformer-base vocab-parallel (the WMT program on a {"dp":
   1, "mp": 2} mesh whose rule table vocab-shards softmax_out.w): two
   ranks spawned on the one card over a gloo group, each holding its
   [512, 5000] slab and running sharded_linear_xent's kernels (parts 2,
   dx 1, dw 1 a step, no fused_linear_xent), 2 warm-up steps and 5 timed;
   the first 3 steps' losses and the gathered softmax_out.w against a
   one-process unsharded run, the replicated state bit-equal across the
   ranks, and the narrow config of the CPU tests on the card's ranks vs
   the CPU's; the kernel phase holds the three B12 kernels at the path's
   shapes, a ragged R and TinyLlama's widths on mp 4 (with --profile,
   rank 0's chiprun_out/profile_training_vocab_parallel.json);
21. trains the packed causal LM (examples/packed_training_torch.py's
   build at GPT-2 small's vocab 50257, width 768, 12 heads and context
   1024; one attention block over packed segment ids, Adam) on the first
   8 rows of 64 seeded ragged sequences (lengths log-uniform in [8,
   1024]) packed into rows of 1024: one warm-up step (its masked loss
   near ln 50257), 10 timed steps with the launch counts held to the
   program's (flash forward 2, dq 1, dk/dv 1), the bit-equal repeat;
   then the same with a 256-position sliding window (the window and
   the segment ids in one kernel call), and a narrow packed LM at window
   0 and 48 card vs CPU; the kernel phase holds the segment and window
   forms of B3 and B9 (with --profile, chiprun_out/profile_training_packed
   and profile_training_packed_window.json);
22. prints the kernels line and, last, the result line.

Any failure raises and exits non-zero.  It imports torch and the port,
never jax or paddle_tpu.  TF32 is off for matmuls and cuDNN.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# GPT-2 small serving pool of the smoke run
N_SLOTS, WIDTH, T_MAX = 8, 16, 1024
# Transformer-base training step: batch 64 x (64 source, 64 target) tokens
TRAIN_BATCH, TRAIN_LEN = 64, 64
TRAIN_ROWS = TRAIN_BATCH * TRAIN_LEN  # 4096 target rows per step
HP_D_MODEL, HP_VOCAB, HP_HEADS = 512, 10000, 8  # ModelHyperParams' widths
TRAIN_STEPS = 10
# the vocab-parallel path: Transformer-base on a {"dp": 1, "mp": 2} mesh,
# softmax_out.w vocab-sharded; two ranks share the one card over gloo
VP_MP = 2
VP_WARMUP, VP_STEPS = 2, 5
# GPT-2 small training step: batch 8 x 1024 tokens
GPT2_BATCH, GPT2_LEN = 8, 1024
GPT2_ROWS = GPT2_BATCH * GPT2_LEN  # 8192 target rows per step
GPT2_D, GPT2_VOCAB, GPT2_HEADS = 768, 50257, 12
# TinyLlama-1.1B's widths: served at t_max 2048, trained on 2 x 2048 tokens
LLAMA_BATCH, LLAMA_LEN = 2, 2048
LLAMA_ROWS = LLAMA_BATCH * LLAMA_LEN  # 4096 target rows per step
LLAMA_D, LLAMA_FF, LLAMA_VOCAB, LLAMA_HEADS = 2048, 5632, 32000, 32
LLAMA_STEPS = 5  # timed steps: a ~3 s step keeps the run well in its limit
# BERT-base pretraining step: batch 32 x 128 tokens (MLM over every
# position, NSP on [CLS])
BERT_BATCH, BERT_LEN = 32, 128
BERT_ROWS = BERT_BATCH * BERT_LEN  # 4096 MLM rows per step
BERT_D, BERT_FF, BERT_VOCAB, BERT_HEADS = 768, 3072, 30522, 12
# KV-cached decode: GPT-2 small over 4 prompts of 200 tokens (chunked
# prefill 64 wide, 56 new tokens; beam 4 over 2 prompts), and the
# TinyLlama widths over 2 prompts of 256 (chunks of 128, 32 new tokens)
DECODE_BATCH, DECODE_PROMPT, DECODE_WIDTH, DECODE_NEW = 4, 200, 64, 56
BEAM_PROMPTS, BEAM_SIZE, BEAM_NEW, SAMPLE_NEW = 2, 4, 16, 24
LLAMA_DECODE_BATCH, LLAMA_DECODE_PROMPT = 2, 256
LLAMA_DECODE_WIDTH, LLAMA_DECODE_NEW = 128, 32
# the decode checks: chunked against one-token prefill over the prompt's
# first chunk and 8 tokens of the next; cached against uncached greedy
# over the first 16 new tokens
PREFILL_CHECK_EXTRA, GREEDY_CHECK_NEW = 8, 16
# rows of the decode programs' fc, fused_swiglu, add-LN and layer norm
# launches: GPT-2's one-token and wide steps (batch 4), its beam steps
# (batch 8), and the TinyLlama widths' (batch 2)
DECODE_ROWS = (
    ("gpt2_decode", DECODE_BATCH, GPT2_D),
    ("gpt2_prefill", DECODE_BATCH * DECODE_WIDTH, GPT2_D),
    ("gpt2_beam", BEAM_PROMPTS * BEAM_SIZE, GPT2_D),
    ("gpt2_beam_prefill", BEAM_PROMPTS * BEAM_SIZE * DECODE_WIDTH, GPT2_D),
    ("llama_decode", LLAMA_DECODE_BATCH, LLAMA_D),
    ("llama_prefill", LLAMA_DECODE_BATCH * LLAMA_DECODE_WIDTH, LLAMA_D))
# the stacked dynamic LSTM (bench.py's stacked_lstm setting, after Paddle's
# benchmark/fluid/models/stacked_dynamic_lstm.py): dict 10000, 64 tokens,
# emb and hidden 512, 3 layers, batch 32
LSTM_BATCH, LSTM_LEN, LSTM_DICT, LSTM_H, LSTM_STACK = 32, 64, 10000, 512, 3
# the GRU seq2seq model at Paddle's benchmark machine_translation widths
# (512, dictionaries 30000), batch 32 x 50 tokens; beam 4 over 2
# sentences, 16 steps
S2S_BATCH, S2S_LEN, S2S_DICT, S2S_H = 32, 50, 30000, 512
S2S_BEAM, S2S_BEAM_SENTS, S2S_BEAM_STEPS = 4, 2, 16
RNN_STEPS = 5  # timed steps of each recurrent training path
# the packed causal LM (examples/packed_training_torch.py) at GPT-2 small's
# vocab, width, heads and context: 64 seeded ragged sequences packed into
# rows of 1024, the first 8 rows kept; its one attention block causal over
# the packed segment ids, and with a 256-position sliding window
PACKED_ROWS, PACKED_SEQS, PACKED_WINDOW = 8, 64, 256
PACKED_STEPS = 10
SERVING_KERNELS = ("fused_add_layer_norm", "matmul_bias_act",
                   "flash_attention_qvec")
GPT2_KERNELS = ("fused_layer_norm", "flash_attention_fwd",
                "flash_attention_dq", "flash_attention_dkv")
# H100 SXM published peaks (NVIDIA data sheet) used for bound_ms
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def tinyllama_config():
    """TinyLlama-1.1B's published config (TinyLlama/TinyLlama-1.1B: hidden
    2048, intermediate 5632, 22 layers, 32 query and 4 KV heads, vocab
    32000, context 2048, RoPE base 10000, untied head) as a GPT2Config
    with the modern-decoder options: SwiGLU's 2/3 of 4 x 2048 = 5461
    rounds up to 5632 at ffn_multiple_of 256.  Kept from the repo's
    builder: LayerNorm with a bias where TinyLlama has RMSNorm, a bias on
    ffn_out, random weights.  Dropout 0, as in LLaMA pretraining."""
    from paddle_tpu_torch.models import gpt2

    class TinyLlama(gpt2.GPT2Config):
        vocab_size, n_ctx, d_model, n_layer = 32000, 2048, 2048, 22
        n_head, n_kv_head = 32, 4
        use_rotary = use_swiglu = True
        ffn_multiple_of = 256
        dropout = 0.0
        tie_embeddings = False

    return TinyLlama


def narrow_modern_config():
    """A narrow config with every modern-decoder option, head dim 64 (the
    kernels' width): vocab 1000, n_ctx 128, d_model 256, 4 query and 2 KV
    heads, 2 layers, SwiGLU at ffn_multiple_of 64, rotary, dropout 0."""
    from paddle_tpu_torch.models import gpt2

    class NarrowModern(gpt2.GPT2Config):
        vocab_size, n_ctx, d_model, n_layer = 1000, 128, 256, 2
        n_head, n_kv_head = 4, 2
        use_rotary = use_swiglu = True
        ffn_multiple_of = 64
        dropout = 0.0

    return NarrowModern


def _example(name):
    """An example module of the repository, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def packed_batch(n_rows, seq_len, vocab, n_seqs, seed=0):
    """(feed, seg) of the packed LM: `n_seqs` sequences with lengths
    log-uniform in [8, seq_len] and tokens uniform in [1, vocab), all
    from RandomState(seed), packed by the example's make_feed into rows
    of `seq_len`; the first `n_rows` rows kept.  seg is the packing's
    segment ids (feed["seg"] drops each segment's last token, which has
    no label, into segment 0, as the example feeds it)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = np.exp(rng.uniform(np.log(8), np.log(seq_len), n_seqs))
    seqs = [rng.randint(1, vocab, int(n)) for n in lengths]
    feed, seg = _example("packed_training_torch").make_feed(seqs, seq_len)
    assert seg.shape[0] >= n_rows, seg.shape
    return {k: a[:n_rows] for k, a in feed.items()}, seg[:n_rows]


def _sh(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (out.stdout or out.stderr).strip()
    except OSError as e:
        return "unavailable (%s)" % e


def _time_ms(fn, reps=5, inner=20):
    """Device time of one call, in ms: `inner` calls are captured into a
    CUDA graph, and the median over `reps` replays, each timed with CUDA
    events, is divided by `inner`.  The replay takes Python and the
    launch path out of the number: launched one by one from Python, a
    kernel of a few microseconds would measure the host instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(dev):
    """Each kernel against its plain version at the path's shapes and
    ragged ones; returns {name: record} with error and times."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (
        MM_ACTS,
        add_layer_norm_plain,
        flash_attention_qvec,
        flash_attention_qvec_plain,
        fused_add_layer_norm,
        matmul_bias_act,
        matmul_bias_act_plain,
    )

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rec = {}
    rows = N_SLOTS * WIDTH  # 128 rows per step
    d_model, d_ff = 768, 3072
    marks = [time.time()]

    def mark(what):
        """Prints the wall seconds of the check that just ended."""
        torch.cuda.synchronize()
        marks.append(time.time())
        print("kernel check %s: %.1f s" % (what, marks[-1] - marks[-2]))

    # ---- fused_add_layer_norm: 16 R H bytes ---------------------------
    err = 0.0
    # the serving rows, ragged ones, the WMT step's [4096, 512], the GPT-2
    # step's [8192, 768], the TinyLlama steps' [4096, 2048] and
    # [128, 2048], the BERT step's [4096, 768] and the decode steps' rows
    for r, h in ((rows, d_model), (7, d_model), (1, d_model),
                 (TRAIN_ROWS, HP_D_MODEL), (5, HP_D_MODEL),
                 (GPT2_ROWS, GPT2_D), (LLAMA_ROWS, LLAMA_D), (rows, LLAMA_D),
                 (BERT_ROWS, BERT_D)) + tuple(
                     (r, h) for _, r, h in DECODE_ROWS):
        x, y = randn(r, h), randn(r, h)
        gam, bet = randn(h), randn(h)
        outs = fused_add_layer_norm(x, y, gam, bet, 1e-5)
        plain = add_layer_norm_plain(x, y, gam, bet, 1e-5)
        for got, want in zip(outs, plain):  # s, y, mean, variance
            err = max(err, (got - want).abs().max().item())
    assert err <= 1e-5, ("fused_add_layer_norm disagrees", err)
    x, y = randn(rows, d_model), randn(rows, d_model)
    gam, bet = randn(d_model), randn(d_model)
    b, fl = _bound_ms(16 * rows * d_model + 8 * d_model + 8 * rows,
                      10 * rows * d_model)
    rec["fused_add_layer_norm"] = dict(
        route="cuda", source="paddle_tpu_torch/kernels/csrc/add_layer_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:1400",
        shape="x, y [%d, %d]" % (rows, d_model), max_abs_err=err,
        ms=_time_ms(lambda: fused_add_layer_norm(x, y, gam, bet, 1e-5)),
        plain_ms=_time_ms(lambda: add_layer_norm_plain(x, y, gam, bet, 1e-5)),
        library_ms=_time_ms(lambda: F.layer_norm(x + y, (d_model,), gam, bet,
                                                 1e-5)),
        bound_ms=b, bound_by=fl)
    per_shape = rec["fused_add_layer_norm"]["per_shape"] = {}
    for tag, r, h in (("train", TRAIN_ROWS, HP_D_MODEL),
                      ("gpt2", GPT2_ROWS, GPT2_D),
                      ("llama_train", LLAMA_ROWS, LLAMA_D),
                      ("llama_serve", rows, LLAMA_D),
                      ("bert", BERT_ROWS, BERT_D)) + DECODE_ROWS:
        x, y = randn(r, h), randn(r, h)
        gam, bet = randn(h), randn(h)
        b, fl = _bound_ms(16 * r * h + 8 * h + 8 * r, 10 * r * h)
        per_shape["%s [%d, %d]" % (tag, r, h)] = dict(
            ms=_time_ms(lambda: fused_add_layer_norm(x, y, gam, bet, 1e-5)),
            plain_ms=_time_ms(lambda: add_layer_norm_plain(x, y, gam, bet,
                                                           1e-5)),
            library_ms=_time_ms(lambda: F.layer_norm(x + y, (h,), gam, bet,
                                                     1e-5)),
            bound_ms=b, bound_by=fl)

    mark("fused_add_layer_norm")

    # ---- matmul_bias_act: unit-scale outputs (w ~ N(0, 1/K)) ----------
    err = 0.0
    cases = [(rows, d_model, d_ff, "gelu"), (rows, d_ff, d_model, ""),
             (100, d_model, d_ff, "gelu")]
    cases += [(37, 100, 70, a) for a in MM_ACTS]
    # split-K with a ragged last slice (K = 1000, 1600: 2 and 3 slices)
    cases += [(37, 1000, 70, "gelu"), (45, 1600, 90, "swish")]
    # the training step's FFN: K = 2048 runs slices of 768, 768 and 512
    cases += [(TRAIN_ROWS, HP_D_MODEL, 4 * HP_D_MODEL, "relu"),
              (TRAIN_ROWS, 4 * HP_D_MODEL, HP_D_MODEL, "")]
    # the GPT-2 training step's FFN: K = 3072 runs four slices of 768
    cases += [(GPT2_ROWS, GPT2_D, 4 * GPT2_D, "gelu"),
              (GPT2_ROWS, 4 * GPT2_D, GPT2_D, "")]
    # the TinyLlama steps' ffn_out: K = 5632 runs seven slices of 768 and a
    # ragged last one of 256
    cases += [(LLAMA_ROWS, LLAMA_FF, LLAMA_D, ""), (rows, LLAMA_FF, LLAMA_D, "")]
    # the BERT step's FFN (relu), MLM transform (gelu), pooler (tanh) and
    # NSP head (N = 2)
    cases += [(BERT_ROWS, BERT_D, BERT_FF, "relu"),
              (BERT_ROWS, BERT_FF, BERT_D, ""),
              (BERT_ROWS, BERT_D, BERT_D, "gelu"),
              (BERT_BATCH, BERT_D, BERT_D, "tanh"), (BERT_BATCH, BERT_D, 2, "")]
    # the decode steps' FFN: GPT-2's gelu ffn_in and ffn_out, the
    # TinyLlama widths' ffn_out (its ffn_in is matmul_swiglu)
    decode_fc = []
    for tag, r, h in DECODE_ROWS:
        if h == GPT2_D:
            decode_fc += [(tag + "_ffn_in", (r, h, 4 * h, "gelu")),
                          (tag + "_ffn_out", (r, 4 * h, h, ""))]
        else:
            decode_fc.append((tag + "_ffn_out", (r, LLAMA_FF, h, "")))
    cases += [shape for _, shape in decode_fc]
    for m, k, n, act in cases:
        xm, wm, bm = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n)
        for bias in (bm, None):
            out = matmul_bias_act(xm, wm, bias, act)
            ref = matmul_bias_act_plain(xm, wm, bias, act)
            err = max(err, (out - ref).abs().max().item())
    assert err <= 1e-4, ("matmul_bias_act disagrees", err)
    times = {}
    for tag, (m, k, n, act) in (
            ("ffn_in", (rows, d_model, d_ff, "gelu")),
            ("ffn_out", (rows, d_ff, d_model, "")),
            ("train_ffn_in", (TRAIN_ROWS, HP_D_MODEL, 4 * HP_D_MODEL, "relu")),
            ("train_ffn_out", (TRAIN_ROWS, 4 * HP_D_MODEL, HP_D_MODEL, "")),
            ("gpt2_ffn_in", (GPT2_ROWS, GPT2_D, 4 * GPT2_D, "gelu")),
            ("gpt2_ffn_out", (GPT2_ROWS, 4 * GPT2_D, GPT2_D, "")),
            ("llama_ffn_out", (LLAMA_ROWS, LLAMA_FF, LLAMA_D, "")),
            ("llama_serve_ffn_out", (rows, LLAMA_FF, LLAMA_D, "")),
            ("bert_ffn_in", (BERT_ROWS, BERT_D, BERT_FF, "relu")),
            ("bert_ffn_out", (BERT_ROWS, BERT_FF, BERT_D, "")),
            ("bert_mlm_trans", (BERT_ROWS, BERT_D, BERT_D, "gelu")),
            *decode_fc):
        xm, wm, bm = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n)
        act_fn = {"gelu": F.gelu, "relu": F.relu}.get(act)
        lib = ((lambda: act_fn(torch.addmm(bm, xm, wm))) if act
               else (lambda: torch.addmm(bm, xm, wm)))
        b, fl = _bound_ms(4 * (m * k + k * n + n + m * n), 2 * m * k * n)
        inner = 5 if m * k * n > 2e10 else 20  # the Llama step: ~6 ms a call
        times[tag] = dict(
            ms=_time_ms(lambda: matmul_bias_act(xm, wm, bm, act), inner=inner),
            plain_ms=_time_ms(lambda: matmul_bias_act_plain(xm, wm, bm, act),
                              inner=inner),
            library_ms=_time_ms(lib, inner=inner), bound_ms=b, bound_by=fl)
        print("matmul_bias_act %s [%d, %d] @ [%d, %d] %s: %s" % (
            tag, m, k, k, n, act or "identity", json.dumps(times[tag])))
    # each shape launches once per layer and step: the line reports the
    # launch-weighted mean over both, with each shape's own numbers beside
    rec["matmul_bias_act"] = dict(
        route="cuda", source="paddle_tpu_torch/kernels/csrc/matmul_bias_act.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:1257",
        shape="mean of ffn_in [%d, %d] @ [%d, %d] + bias, gelu and ffn_out "
              "[%d, %d] @ [%d, %d] + bias, one launch each per layer" % (
                  rows, d_model, d_model, d_ff, rows, d_ff, d_ff, d_model),
        max_abs_err=err, bound_by=times["ffn_in"]["bound_by"],
        per_shape=times)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        rec["matmul_bias_act"][key] = (
            times["ffn_in"][key] + times["ffn_out"][key]) / 2

    mark("matmul_bias_act")

    # ---- flash_attention_qvec: live K/V prefix bytes -------------------
    heads, dh, tq, tk = 12, 64, WIDTH, T_MAX
    err = 0.0
    # per slot: 0, mid-cache, Tk - Tq, a decode row, and width-0 free slots;
    # then head dim 128 over three key slices (the last one ragged, and
    # dead for the row at 0), and one slice of 40 keys
    slot_q = [0, 500, tk - tq, 37, 0, 250, 999, 1]
    # the TinyLlama serving step: 8 slots x 32 heads over its t_max 2048
    # cache (16 key slices)
    llama_q = [0, 1000, LLAMA_LEN - tq, 37, 0, 1500, 2000, 1]
    for d, qs_slots, n_tk, per in ((dh, slot_q, tk, heads),
                                   (128, [0, 130, 300 - 4], 300, 2),
                                   (64, [3, 0], 40, 2),
                                   (dh, llama_q, LLAMA_LEN, LLAMA_HEADS)):
        bh = len(qs_slots) * per
        tq_ = tq if d == dh else 4
        q, k_, v = randn(bh, tq_, d), randn(bh, n_tk, d), randn(bh, n_tk, d)
        qs = torch.tensor(qs_slots, device=dev).repeat_interleave(per)
        out = flash_attention_qvec(q, k_, v, qs, d ** -0.5)
        ref = flash_attention_qvec_plain(q, k_, v, qs, d ** -0.5)
        err = max(err, (out - ref).abs().max().item())
    assert err <= 1e-5, ("flash_attention_qvec disagrees", err)
    rec["flash_attention_qvec"] = dict(
        route="cuda",
        source="paddle_tpu_torch/kernels/csrc/flash_attention_qvec.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:621",
        shape="q [%d, %d, %d], k/v [%d, %d, %d], qstart = Tk - Tq" % (
            N_SLOTS * heads, tq, dh, N_SLOTS * heads, tk, dh),
        max_abs_err=err, **_qvec_times(dev, randn, N_SLOTS * heads, tq, tk, dh))
    bh = N_SLOTS * LLAMA_HEADS
    rec["flash_attention_qvec"]["per_shape"] = {
        "llama_serve q [%d, %d, %d], k/v [%d, %d, %d]" % (
            bh, tq, dh, bh, LLAMA_LEN, dh):
        _qvec_times(dev, randn, bh, tq, LLAMA_LEN, dh)}
    torch.cuda.synchronize()
    mark("flash_attention_qvec")
    rec.update(check_linear_xent(dev, randn, g))
    mark("linear_xent")
    rec.update(check_sharded_linear_xent(dev, randn, g))
    mark("sharded_linear_xent")
    rec.update(check_layer_norm(randn))
    mark("fused_layer_norm")
    rec.update(check_flash_attention(dev, randn))
    mark("flash_attention")
    rec.update(check_matmul_swiglu(randn))
    mark("matmul_swiglu")
    rec.update(check_softmax_xent(dev, randn, g))
    mark("softmax_xent")
    rec.update(check_attention_pieces(dev, randn))
    mark("flash_attention_piece, qvec backward")
    rec.update(check_recurrent(dev, randn, g))
    mark("fused_lstm, fused_gru")
    return rec


def _qvec_times(dev, randn, bh, tq, tk, dh):
    """flash_attention_qvec's times at one shape with every row's cutoff at
    the last key (qstart = Tk - Tq), beside the plain version and masked
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (flash_attention_qvec,
                                          flash_attention_qvec_plain)

    q, k_, v = randn(bh, tq, dh), randn(bh, tk, dh), randn(bh, tk, dh)
    qs = torch.full((bh,), tk - tq, device=dev, dtype=torch.long)
    live = tk  # every row's cutoff reaches the last key
    mask = (qs[:, None, None] + torch.arange(tq, device=dev)[None, :, None]
            >= torch.arange(tk, device=dev)[None, None, :])
    b, fl = _bound_ms(4 * (2 * bh * tq * dh + 2 * bh * live * dh) + 4 * bh,
                      4 * bh * tq * live * dh)
    return dict(
        ms=_time_ms(lambda: flash_attention_qvec(q, k_, v, qs, dh ** -0.5)),
        plain_ms=_time_ms(lambda: flash_attention_qvec_plain(q, k_, v, qs,
                                                             dh ** -0.5)),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            q, k_, v, attn_mask=mask, scale=dh ** -0.5)),
        bound_ms=b, bound_by=fl)


def check_matmul_swiglu(randn):
    """matmul_swiglu against its plain version at the TinyLlama paths'
    shapes (training x [4096, 2048], serving x [128, 2048], one-token
    decode x [2, 2048], chunked prefill x [256, 2048], all against wg/wu
    [2048, 5632]) and a ragged one ([200, 1000] @ [1000, 333]);
    limit 1e-4 of the plain output's largest magnitude.  Timed beside the
    plain version and the library's two matmuls + silu(g) * u."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import matmul_swiglu, matmul_swiglu_plain

    shapes = (("train", LLAMA_ROWS, LLAMA_D, LLAMA_FF),
              ("serve", N_SLOTS * WIDTH, LLAMA_D, LLAMA_FF),
              ("ragged", 200, 1000, 333)) + tuple(
                  (tag, r, h, LLAMA_FF) for tag, r, h in DECODE_ROWS
                  if h == LLAMA_D)
    err = err_abs = 0.0
    times = {}
    for tag, m, k, n in shapes:
        x = randn(m, k)
        wg, wu = randn(k, n, scale=k ** -0.5), randn(k, n, scale=k ** -0.5)
        out = matmul_swiglu(x, wg, wu)
        ref = matmul_swiglu_plain(x, wg, wu)
        diff = (out - ref).abs().max()
        err = max(err, (diff / ref.abs().max()).item())
        err_abs = max(err_abs, diff.item())
        if tag == "ragged":
            continue
        inner = 5 if tag == "train" else 20  # ~10 ms a call in training
        b, fl = _bound_ms(4 * (m * k + 2 * k * n + m * n), 4 * m * k * n)
        times["%s [%d, %d] @ [%d, %d]" % (tag, m, k, k, n)] = dict(
            ms=_time_ms(lambda: matmul_swiglu(x, wg, wu), inner=inner),
            plain_ms=_time_ms(lambda: matmul_swiglu_plain(x, wg, wu),
                              inner=inner),
            library_ms=_time_ms(lambda: F.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), inner=inner),
            bound_ms=b, bound_by=fl)
    assert err <= 1e-4, ("matmul_swiglu disagrees", err)
    torch.cuda.synchronize()
    head = times["train [%d, %d] @ [%d, %d]" % (LLAMA_ROWS, LLAMA_D, LLAMA_D,
                                                 LLAMA_FF)]
    return {"matmul_swiglu": dict(
        route="cuda", source="paddle_tpu_torch/kernels/csrc/matmul_bias_act.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:1325",
        shape="x [%d, %d], wg/wu [%d, %d] (training); per_shape adds the "
              "serving and decode steps'" % (LLAMA_ROWS, LLAMA_D, LLAMA_D,
                                             LLAMA_FF),
        max_abs_err=err_abs, max_rel_err=err, per_shape=times, **head)}


def _events_ms(fn, reps=5):
    """Device time of one call of a ms-scale function (autograd inside,
    so no graph capture): CUDA events around `reps` calls after two
    warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_linear_xent(dev, randn, g):
    """The three linear cross-entropy kernels (forward, dx, dw) against
    the plain version on the card: the training path's shapes (R 4096, H
    512, V 10000, eps 0.1) and ragged ones (R 100, V 1007, labels -1 and
    V in the batch, eps 0 and 0.1; R 70, H 600, V 300), the GPT-2 path's
    (R 8192, H 768, V 50257, eps 0: the wide-H form) and the TinyLlama
    path's (R 4096, H 2048, V 32000, eps 0: the wide-H form over 8 H
    slices) and the BERT path's MLM head (R 4096, H 768, V 30522, eps 0),
    the last three timed as `per_shape`.  Limit: 1e-4 of the
    largest magnitude of each of loss, dx and dw."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import linear_xent as lx

    R, H, V, eps = TRAIN_ROWS, HP_D_MODEL, HP_VOCAB, 0.1
    err = {"loss": 0.0, "dx": 0.0, "dw": 0.0}  # relative to the max magnitude
    err_abs = dict(err)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    def note(key, *pairs):
        for a, b in pairs:
            err[key] = max(err[key], rel(a, b))
            err_abs[key] = max(err_abs[key], (a - b).abs().max().item())

    # H 600 takes the backward's form for H > 512 (16-deep staged slices)
    for r, h, v, e in ((R, H, V, eps), (100, H, 1007, 0.0), (100, H, 1007, 0.1),
                       (70, 600, 300, 0.1), (GPT2_ROWS, GPT2_D, GPT2_VOCAB, 0.0),
                       (LLAMA_ROWS, LLAMA_D, LLAMA_VOCAB, 0.0),
                       (BERT_ROWS, BERT_D, BERT_VOCAB, 0.0)):
        x, w = randn(r, h), randn(h, v, scale=h ** -0.5)
        lbl = torch.randint(0, v, (r,), generator=g, device=dev)
        lbl[0], lbl[1] = -1, v  # outside the vocab: smoothing term only
        dy = torch.rand(r, 1, generator=g, device=dev)
        loss, lse = lx.linear_xent_fwd(x, w, lbl, e)
        p_loss, p_lse = lx.linear_xent_plain(x, w, lbl, e)
        dx = lx.linear_xent_dx(x, w, lbl, lse, dy, e)
        dw = lx.linear_xent_dw(x, w, lbl, lse, dy, e)
        p_dx, p_dw = lx.linear_xent_grad_plain(x, w, lbl, p_lse, dy, e)
        note("loss", (loss, p_loss), (lse, p_lse))
        note("dx", (dx, p_dx))
        note("dw", (dw, p_dw))
    for k, v_ in err.items():
        assert v_ <= 1e-4, ("linear_xent disagrees", k, v_)

    rec = {}
    for name, site, e in (("linear_xent_fwd", ":1647", "loss"),
                          ("linear_xent_dx", ":1680", "dx"),
                          ("linear_xent_dw", ":1693", "dw")):
        rec[name] = dict(
            route="cuda", source="paddle_tpu_torch/kernels/csrc/linear_xent.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site,
            max_abs_err=err_abs[e], max_rel_err=err[e])
    for tag, (r, h, v, e) in (
            ("wmt", (R, H, V, eps)),
            ("gpt2", (GPT2_ROWS, GPT2_D, GPT2_VOCAB, 0.0)),
            ("llama", (LLAMA_ROWS, LLAMA_D, LLAMA_VOCAB, 0.0)),
            ("bert", (BERT_ROWS, BERT_D, BERT_VOCAB, 0.0))):
        for name, times in _lxent_times(dev, randn, g, r, h, v, e,
                                        slow=tag != "wmt").items():
            if tag == "wmt":
                rec[name].update(times)
            else:
                rec[name].setdefault("per_shape", {})[
                    "%s %s" % (tag, times.pop("shape"))] = times
    torch.cuda.synchronize()
    return rec


def _lxent_times(dev, randn, g, R, H, V, eps, slow):
    """Times of the three linear cross-entropy kernels at one shape,
    beside the plain version and matmul + cross_entropy.  `slow` shapes
    (hundreds of ms a call) are timed with CUDA events over 3 calls."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import linear_xent as lx

    x, w = randn(R, H), randn(H, V, scale=H ** -0.5)
    lbl = torch.randint(0, V, (R,), generator=g, device=dev)
    dy = torch.rand(R, 1, generator=g, device=dev)
    _, lse = lx.linear_xent_fwd(x, w, lbl, eps)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

    def library_fwd():
        return F.cross_entropy(torch.matmul(x, w), lbl, label_smoothing=eps,
                               reduction="none")

    def library_fwd_bwd():
        loss = F.cross_entropy(torch.matmul(xg, wg), lbl, label_smoothing=eps,
                               reduction="none")
        return torch.autograd.grad(loss, (xg, wg), dy.reshape(-1))

    def timed(fn):
        return _events_ms(fn, reps=3) if slow else _time_ms(fn, reps=5,
                                                             inner=5)

    plain_grad = _events_ms(
        lambda: lx.linear_xent_grad_plain(x, w, lbl, lse, dy, eps))
    lib_fwd_bwd = _events_ms(library_fwd_bwd)
    fwd_bytes = 4 * (R * H + H * V) + 8 * R + 4 * 2 * R
    bwd_bytes = 4 * (R * H + H * V) + 8 * R + 4 * 2 * R
    shape = "x [%d, %d], w [%d, %d], eps %.1f" % (R, H, H, V, eps)
    specs = (
        ("linear_xent_fwd",
         lambda: lx.linear_xent_fwd(x, w, lbl, eps),
         lambda: lx.linear_xent_plain(x, w, lbl, eps), library_fwd,
         fwd_bytes, 2 * R * H * V),
        ("linear_xent_dx",
         lambda: lx.linear_xent_dx(x, w, lbl, lse, dy, eps), None, None,
         bwd_bytes + 4 * R * H, 4 * R * H * V),
        ("linear_xent_dw",
         lambda: lx.linear_xent_dw(x, w, lbl, lse, dy, eps), None, None,
         bwd_bytes + 4 * H * V, 4 * R * H * V),
    )
    out = {}
    for name, kern, plain, lib, nbytes, flops in specs:
        b, fl = _bound_ms(nbytes, flops)
        out[name] = dict(
            shape=shape + ("" if plain else
                           "; plain_ms is the plain backward (dx and dw "
                           "together), library_ms matmul + cross_entropy "
                           "forward and backward"),
            ms=timed(kern), plain_ms=timed(plain) if plain else plain_grad,
            library_ms=timed(lib) if lib else lib_fwd_bwd,
            bound_ms=b, bound_by=fl)
    return out


def check_sharded_linear_xent(dev, randn, g):
    """sharded_linear_xent's three kernels (parts, dx, dw) against their
    plain versions on one vocab shard: the vocab-parallel path's x [4096,
    512], w_local [512, 5000] (mp 2, the slab at col0 5000 of 10000), eps
    0.1, labels over the whole vocab (half outside the shard) with a few at
    -1 and 10000; a ragged R of 4095; and the wide-H form at TinyLlama's
    widths on mp 4, [4096, 2048] x [2048, 8000] of 32000, eps 0.  The lse
    handed to dx/dw is a global one (this shard's plus log 2).  Limit:
    1e-4 of the largest magnitude of each output; a rerun is bit-equal.
    Each shape is timed: the path's in the record, the others as
    `per_shape`."""
    import torch

    import importlib

    slx = importlib.import_module("paddle_tpu_torch.kernels.sharded_linear_xent")

    err = {"parts": 0.0, "dx": 0.0, "dw": 0.0}  # relative to the max magnitude
    err_abs = dict(err)

    def note(key, a, b):
        err[key] = max(err[key], ((a - b).abs().max() / b.abs().max()
                                  .clamp_min(1e-30)).item())
        err_abs[key] = max(err_abs[key], (a - b).abs().max().item())

    shapes = ((TRAIN_ROWS, HP_D_MODEL, HP_VOCAB // VP_MP, 0.1, HP_VOCAB, 1),
              (TRAIN_ROWS - 1, HP_D_MODEL, HP_VOCAB // VP_MP, 0.1, HP_VOCAB, 0),
              (LLAMA_ROWS, LLAMA_D, LLAMA_VOCAB // 4, 0.0, LLAMA_VOCAB, 2))
    for r, h, v, eps, vt, shard in shapes:
        x, w = randn(r, h), randn(h, v, scale=h ** -0.5)
        lbl = torch.randint(0, vt, (r,), generator=g, device=dev)
        lbl[:3] = torch.tensor([-1, vt, shard * v], device=dev)
        lbl_local = lbl - shard * v
        valid = ((lbl >= 0) & (lbl < vt)).float()
        dy = torch.rand(r, 1, generator=g, device=dev)
        parts = slx.linear_xent_parts(x, w, lbl_local)
        p_parts = slx.linear_xent_parts_plain(x, w, lbl_local)
        assert all(torch.equal(a, b) for a, b in zip(
            parts, slx.linear_xent_parts(x, w, lbl_local))), "parts rerun"
        for a, b in zip(parts, p_parts):
            note("parts", a, b)
        lse = p_parts[0] + 0.6931471805599453
        args = (x, w, lbl_local, valid, lse, dy, eps, vt)
        dx, dw = slx.linear_xent_dx_sharded(*args), slx.linear_xent_dw_sharded(*args)
        assert torch.equal(dx, slx.linear_xent_dx_sharded(*args)), "dx rerun"
        assert torch.equal(dw, slx.linear_xent_dw_sharded(*args)), "dw rerun"
        p_dx, p_dw = slx.linear_xent_grad_sharded_plain(*args)
        note("dx", dx, p_dx)
        note("dw", dw, p_dw)
    for k, v_ in err.items():
        assert v_ <= 1e-4, ("sharded_linear_xent disagrees", k, v_)

    rec = {}
    for name, site, e in (("linear_xent_parts", ":1818", "parts"),
                          ("linear_xent_dx_sharded", ":1900", "dx"),
                          ("linear_xent_dw_sharded", ":1914", "dw")):
        rec[name] = dict(
            route="cuda", source="paddle_tpu_torch/kernels/csrc/linear_xent.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site,
            max_abs_err=err_abs[e], max_rel_err=err[e])
    for tag, (r, h, v, eps, vt, shard) in (("wmt_vp", shapes[0]),
                                           ("ragged", shapes[1]),
                                           ("llama_mp4", shapes[2])):
        for name, times in _sharded_lxent_times(
                dev, randn, g, r, h, v, eps, vt, shard,
                slow=tag == "llama_mp4").items():
            if tag == "wmt_vp":
                rec[name].update(times)
            else:
                rec[name].setdefault("per_shape", {})[
                    "%s %s" % (tag, times.pop("shape"))] = times
    torch.cuda.synchronize()
    return rec


def _sharded_lxent_times(dev, randn, g, R, H, V, eps, vocab_total, shard,
                         slow):
    """Times of the three sharded kernels at one shape, beside their plain
    versions and the dense PyTorch yardsticks: matmul, logsumexp, the
    gold-column gather and the row sum (parts); the same logits, softmax,
    g, g @ w^T and x^T @ g (dx and dw).  `slow` shapes are timed with CUDA
    events over 3 calls."""
    import torch

    import importlib

    slx = importlib.import_module("paddle_tpu_torch.kernels.sharded_linear_xent")

    x, w = randn(R, H), randn(H, V, scale=H ** -0.5)
    lbl = torch.randint(0, vocab_total, (R,), generator=g, device=dev)
    lbl_local = lbl - shard * V
    valid = ((lbl >= 0) & (lbl < vocab_total)).float()
    dy = torch.rand(R, 1, generator=g, device=dev)
    lse = slx.linear_xent_parts(x, w, lbl_local)[0] + 0.6931471805599453
    args = (x, w, lbl_local, valid, lse, dy, eps, vocab_total)
    cols = torch.arange(V, device=dev)[None, :]
    inside = ((lbl_local >= 0) & (lbl_local < V))

    def library_parts():
        z = torch.matmul(x, w)
        gold = z.gather(1, lbl_local.clamp(0, V - 1)[:, None]) * inside[:, None]
        return torch.logsumexp(z, -1, keepdim=True), gold, z.sum(-1, keepdim=True)

    def library_bwd():
        z = torch.matmul(x, w)
        p = torch.exp(z - lse)
        gg = valid[:, None] * (1.0 - eps) * (p - (cols == lbl_local[:, None]).float())
        if eps:
            gg = gg + eps * (p - 1.0 / vocab_total)
        gg = gg * dy
        return gg @ w.t(), x.t() @ gg

    def timed(fn):
        return _events_ms(fn, reps=3) if slow else _time_ms(fn, reps=5,
                                                             inner=5)

    plain_grad = _events_ms(lambda: slx.linear_xent_grad_sharded_plain(*args))
    lib_bwd = _events_ms(library_bwd)
    in_bytes = 4 * (R * H + H * V) + 8 * R
    shape = "x [%d, %d], w_local [%d, %d] of %d, eps %.1f" % (
        R, H, H, V, vocab_total, eps)
    specs = (
        ("linear_xent_parts", lambda: slx.linear_xent_parts(x, w, lbl_local),
         lambda: slx.linear_xent_parts_plain(x, w, lbl_local), library_parts,
         in_bytes + 4 * 3 * R, 2 * R * H * V),
        ("linear_xent_dx_sharded", lambda: slx.linear_xent_dx_sharded(*args),
         None, None, in_bytes + 4 * 3 * R + 4 * R * H, 4 * R * H * V),
        ("linear_xent_dw_sharded", lambda: slx.linear_xent_dw_sharded(*args),
         None, None, in_bytes + 4 * 3 * R + 4 * H * V, 4 * R * H * V),
    )
    out = {}
    for name, kern, plain, lib, nbytes, flops in specs:
        b, fl = _bound_ms(nbytes, flops)
        out[name] = dict(
            shape=shape + ("" if plain else
                           "; plain_ms is the plain backward (dx and dw "
                           "together), library_ms the dense logits, softmax, "
                           "g @ w^T and x^T @ g"),
            ms=timed(kern), plain_ms=timed(plain) if plain else plain_grad,
            library_ms=timed(lib) if lib else lib_bwd,
            bound_ms=b, bound_by=fl)
    return out


def check_softmax_xent(dev, randn, g):
    """The two softmax cross-entropy kernels (forward, backward) against
    their plain versions on the card: the BERT path's NSP head [32, 2],
    the MLM head's width [4096, 30522] (the row form), a ragged [1000,
    1001] (the warp form, 32 columns a lane) and a ragged [37, 1500] (the
    row form), with labels -1 and C among them; limit 1e-5 of the largest
    magnitude of the loss and of dx.  Two runs at [4096, 30522] must be
    bit-equal.  Timed at every shape but the last, with in-range labels,
    beside the plain version and F.cross_entropy (forward; forward and
    backward for the backward kernel)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import softmax_xent as sx

    shapes = (("nsp", BERT_BATCH, 2), ("mlm", BERT_ROWS, BERT_VOCAB),
              ("ragged", 1000, 1001), ("ragged_row", 37, 1500))
    err = {"fwd": 0.0, "bwd": 0.0}
    err_abs = dict(err)
    times = {"fwd": {}, "bwd": {}}
    for tag, r, c in shapes:
        x = randn(r, c, scale=3.0)
        lbl = torch.randint(0, c, (r,), generator=g, device=dev)
        dy = torch.rand(r, 1, generator=g, device=dev)
        bad = lbl.clone()
        bad[0], bad[-1] = -1, c  # no column: the loss is the lse
        for key, got, want in (
                ("fwd", sx.softmax_xent_fwd(x, bad), sx.softmax_xent_plain(
                    x, bad)),
                ("bwd", sx.softmax_xent_bwd(x, bad, dy),
                 sx.softmax_xent_grad_plain(x, bad, dy))):
            diff = (got - want).abs().max()
            err[key] = max(err[key], (diff / want.abs().max()).item())
            err_abs[key] = max(err_abs[key], diff.item())
        if tag == "mlm":
            assert torch.equal(sx.softmax_xent_fwd(x, bad),
                               sx.softmax_xent_fwd(x, bad)), "fwd not bit-equal"
            assert torch.equal(sx.softmax_xent_bwd(x, bad, dy),
                               sx.softmax_xent_bwd(x, bad, dy)), (
                                   "bwd not bit-equal")
        if tag == "ragged_row":
            continue
        xg = x.clone().requires_grad_()

        def library_fwd_bwd():
            loss = F.cross_entropy(xg, lbl, reduction="none")
            return torch.autograd.grad(loss, (xg,), dy.reshape(-1))

        key = "%s [%d, %d]" % (tag, r, c)
        b, fl = _bound_ms(4 * r * c + 12 * r, 4 * r * c)
        times["fwd"][key] = dict(
            ms=_time_ms(lambda: sx.softmax_xent_fwd(x, lbl)),
            plain_ms=_time_ms(lambda: sx.softmax_xent_plain(x, lbl)),
            library_ms=_time_ms(lambda: F.cross_entropy(x, lbl,
                                                        reduction="none")),
            bound_ms=b, bound_by=fl)
        b, fl = _bound_ms(8 * r * c + 12 * r, 6 * r * c)
        times["bwd"][key] = dict(
            ms=_time_ms(lambda: sx.softmax_xent_bwd(x, lbl, dy)),
            plain_ms=_time_ms(lambda: sx.softmax_xent_grad_plain(x, lbl, dy)),
            library_ms=_events_ms(library_fwd_bwd, reps=10),
            bound_ms=b, bound_by=fl)
    for key, val in err.items():
        assert val <= 1e-5, ("softmax_xent disagrees", key, val)
    torch.cuda.synchronize()
    rec = {}
    head = "nsp [%d, 2]" % BERT_BATCH
    for name, key, site in (("softmax_xent_fwd", "fwd", ":1004"),
                            ("softmax_xent_bwd", "bwd", ":1078")):
        per_shape = times[key]
        rec[name] = dict(
            route="cuda", source="paddle_tpu_torch/kernels/csrc/softmax_xent.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site,
            shape="logits [%d, 2] (the NSP head)%s" % (
                BERT_BATCH, "" if key == "fwd" else
                "; library_ms is F.cross_entropy forward and backward"),
            max_abs_err=err_abs[key], max_rel_err=err[key],
            per_shape={k: v for k, v in per_shape.items() if k != head},
            **per_shape[head])
    return rec


def check_layer_norm(randn):
    """fused_layer_norm against its plain version at the GPT-2 path's
    [8192, 768] rows, the TinyLlama paths' [4096, 2048] and [128, 2048],
    the BERT path's [4096, 768], the decode steps' rows (DECODE_ROWS),
    and ragged row counts; limit 1e-5 absolute on the output and the row
    statistics.  Timed at GPT-2's shape, the others as `per_shape`."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import fused_layer_norm, layer_norm_plain

    err = 0.0
    for r, h in ((GPT2_ROWS, GPT2_D), (7, GPT2_D), (1000, GPT2_D),
                 (LLAMA_ROWS, LLAMA_D), (N_SLOTS * WIDTH, LLAMA_D),
                 (BERT_ROWS, BERT_D)) + tuple(
                     (r, h) for _, r, h in DECODE_ROWS):
        x = randn(r, h, scale=2.0) + 0.5
        gam, bet = randn(h), randn(h)
        for got, want in zip(fused_layer_norm(x, gam, bet, 1e-5),
                             layer_norm_plain(x, gam, bet, 1e-5)):
            err = max(err, (got - want).abs().max().item())
    assert err <= 1e-5, ("fused_layer_norm disagrees", err)

    def times(R, H):
        x, gam, bet = randn(R, H), randn(H), randn(H)
        b, fl = _bound_ms(8 * R * H + 8 * H + 8 * R, 8 * R * H)
        return dict(
            ms=_time_ms(lambda: fused_layer_norm(x, gam, bet, 1e-5)),
            plain_ms=_time_ms(lambda: layer_norm_plain(x, gam, bet, 1e-5)),
            library_ms=_time_ms(lambda: F.layer_norm(x, (H,), gam, bet,
                                                     1e-5)),
            bound_ms=b, bound_by=fl)

    return {"fused_layer_norm": dict(
        route="cuda", source="paddle_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:724",
        shape="x [%d, %d]" % (GPT2_ROWS, GPT2_D), max_abs_err=err,
        per_shape={"%s [%d, %d]" % (tag, r, h): times(r, h)
                   for tag, r, h in (("llama_train", LLAMA_ROWS, LLAMA_D),
                                     ("llama_serve", N_SLOTS * WIDTH,
                                      LLAMA_D),
                                     ("bert", BERT_ROWS, BERT_D))
                   + DECODE_ROWS},
        **times(GPT2_ROWS, GPT2_D))}


def check_flash_attention(dev, randn):
    """The three flash-attention kernels (forward, dq, dk/dv) against the
    plain version on the card: the GPT-2 path's shapes (BH 96, T 1024, d
    64, causal), the TinyLlama path's (BH 64, T 2048, d 64, causal), the
    BERT path's (BH 384, T 128, d 64, key-padding bias, not causal) and
    WMT fused_attn's (BH 512, T 64: key bias, causal and not), the last
    three timed as `per_shape` (WMT's non-causal form), the one-token
    decode steps' forms (GPT-2's Tq 1 over BH 48 x 1024 keys, the
    TinyLlama widths' GQA fold at Tq 8 over BH 8 x 2048 keys, both with
    a key bias; timed as `per_shape`), a key bias with some keys at -1e9
    (causal; non-causal with Tq != Tk), ragged lengths, and head dim
    128; then the packed LM paths' forms: their own segment ids (causal,
    and non-causal with a key bias), window 256 alone and with the ids
    (timed as `per_shape`, the bound over the visible pairs), window 200
    at T 1000 (with ragged ids and a key bias too) and window 100 with
    ids at head dim 128.  Limit:
    1e-4 of the largest magnitude of each of o, dq, dk, dv and dkbias
    (lse: 1e-4 absolute)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import (
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_fwd,
        flash_attention_grad_plain,
        flash_attention_plain,
    )

    err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}  # relative to the max magnitude
    err_abs = dict(err)

    def note(key, got, want):
        err[key] = max(err[key], ((got - want).abs().max()
                                  / want.abs().max().clamp_min(1e-30)).item())
        err_abs[key] = max(err_abs[key], (got - want).abs().max().item())

    bh, t, d = GPT2_BATCH * GPT2_HEADS, GPT2_LEN, GPT2_D // GPT2_HEADS
    llama_bh = LLAMA_BATCH * LLAMA_HEADS
    cases = [(bh, t, t, d, True, False),   # the GPT-2 path
             (llama_bh, LLAMA_LEN, LLAMA_LEN, d, True, False),  # TinyLlama
             (6, 300, 300, 64, True, True),
             (5, 200, 333, 64, False, True),
             (4, 384, 384, 128, True, True),
             (3, 130, 70, 128, False, False),
             # the BERT path: key-padding bias, not causal
             (BERT_BATCH * BERT_HEADS, BERT_LEN, BERT_LEN, d, False, True),
             # WMT's fused_attn path: the source key bias (encoder, cross
             # attention) and the decoder's causal form with a key bias
             (TRAIN_BATCH * HP_HEADS, TRAIN_LEN, TRAIN_LEN, d, False, True),
             (TRAIN_BATCH * HP_HEADS, TRAIN_LEN, TRAIN_LEN, d, True, True),
             # the one-token decode steps: GPT-2's Tq 1 over its cache, and
             # the TinyLlama widths' GQA fold (Tq 8 over 4 kv heads)
             (DECODE_BATCH * GPT2_HEADS, 1, T_MAX, d, False, True),
             (LLAMA_DECODE_BATCH * 4, LLAMA_HEADS // 4, LLAMA_LEN, d, False,
              True)]
    for n, tq, tk, dh, causal, with_bias in cases:
        q, k, v = randn(n, tq, dh), randn(n, tk, dh), randn(n, tk, dh)
        do = randn(n, tq, dh)
        kb = None
        if with_bias:
            kb = randn(n, tk)
            kb[:, -3:] = -1e9
        scale = dh ** -0.5
        o, lse = flash_attention_fwd(q, k, v, kb, causal, scale)
        p_o, p_lse = flash_attention_plain(q, k, v, kb, causal, scale)
        note("fwd", o, p_o)
        assert (lse - p_lse).abs().max().item() <= 1e-4, ("lse", n, tq)
        delta = (do * o).sum(-1)
        dq = flash_attention_dq(q, k, v, kb, lse, do, delta, causal, scale)
        dk, dv, dkb = flash_attention_dkv(q, k, v, kb, lse, do, delta,
                                             causal, scale)
        p_dq, p_dk, p_dv, p_dkb = flash_attention_grad_plain(
            q, k, v, kb, p_lse, do, delta, causal, scale)
        note("dq", dq, p_dq)
        note("dkv", dk, p_dk)
        note("dkv", dv, p_dv)
        if kb is not None:
            note("dkv", dkb, p_dkb)
        else:
            assert dkb is None
    # the packed LM paths' forms: their own segment ids over the heads
    # (causal; and non-causal with a key bias, the bidirectional packing
    # form), window 256 alone and with the ids, a window that is no
    # multiple of the tile at a ragged T, window and ids at head dim 128
    # the ids as the path's fused_attention hands them to the kernels:
    # each row's ids repeated over its heads
    path_seg = torch.tensor(packed_batch(
        PACKED_ROWS, GPT2_LEN, GPT2_VOCAB, PACKED_SEQS)[0]["seg"],
        device=dev).repeat_interleave(GPT2_HEADS, 0)
    pbh = path_seg.shape[0]  # the packed paths' batch x heads rows
    rng = np.random.RandomState(1)

    def ragged_ids(n, t_):
        cuts = np.sort(rng.randint(1, t_, (n, 6)), axis=1)
        ids = (np.arange(t_)[None, :, None] >= cuts[:, None, :]).sum(-1) + 1
        ids[:, t_ - t_ // 10:] = 0  # a padding tail
        return torch.tensor(ids, dtype=torch.int32, device=dev)

    for n, t_, dh, causal, with_bias, window, seg in (
            (pbh, t, d, True, False, 0, path_seg),
            (pbh, t, d, False, True, 0, path_seg),
            (pbh, t, d, True, False, PACKED_WINDOW, None),
            (pbh, t, d, True, False, PACKED_WINDOW, path_seg),
            (6, 1000, 64, True, False, 200, None),
            (5, 1000, 64, True, True, 200, ragged_ids(5, 1000)),
            (4, 384, 128, True, False, 100, ragged_ids(4, 384))):
        q, k, v, do = (randn(n, t_, dh) for _ in range(4))
        kb = randn(n, t_) if with_bias else None
        scale = dh ** -0.5
        o, lse = flash_attention_fwd(q, k, v, kb, causal, scale, window, seg)
        p_o, p_lse = flash_attention_plain(q, k, v, kb, causal, scale, None,
                                           window, seg)
        note("fwd", o, p_o)
        assert (lse - p_lse).abs().max().item() <= 1e-4, ("lse", n, window)
        delta = (do * o).sum(-1)
        dq = flash_attention_dq(q, k, v, kb, lse, do, delta, causal, scale,
                                window, seg)
        dk, dv, dkb = flash_attention_dkv(q, k, v, kb, lse, do, delta, causal,
                                          scale, window, seg)
        p_dq, p_dk, p_dv, p_dkb = flash_attention_grad_plain(
            q, k, v, kb, p_lse, do, delta, causal, scale, None, window, seg)
        for key, got, want in (("dq", dq, p_dq), ("dkv", dk, p_dk),
                               ("dkv", dv, p_dv)) + (
                                   (("dkv", dkb, p_dkb),) if with_bias
                                   else ()):
            note(key, got, want)
        again = flash_attention_dkv(q, k, v, kb, lse, do, delta, causal,
                                    scale, window, seg)
        assert all(torch.equal(a, b) for a, b in zip((dk, dv), again)), (
            "dk/dv rerun differs")
    for key, val in err.items():
        assert val <= 1e-4, ("flash_attention disagrees", key, val)

    rec = {}
    for name, site in (("flash_attention_fwd", ":279"),
                       ("flash_attention_dq", ":447"),
                       ("flash_attention_dkv", ":471")):
        rec[name] = dict(
            route="cuda",
            source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site)
    for tag, n, t_, causal in (
            ("gpt2", bh, t, True), ("llama", llama_bh, LLAMA_LEN, True),
            ("bert", BERT_BATCH * BERT_HEADS, BERT_LEN, False),
            ("wmt", TRAIN_BATCH * HP_HEADS, TRAIN_LEN, False)):
        for name, times in _flash_times(randn, n, t_, d, causal).items():
            if tag == "gpt2":
                rec[name].update(times)
            else:
                rec[name].setdefault("per_shape", {})[
                    "%s %s" % (tag, times.pop("shape"))] = times
    # the packed LM paths' shapes: B3's segment form, its window form and
    # both together (the bound counts the visible pairs only)
    for tag, forms in (("packed", dict(seg=path_seg)),
                       ("window", dict(window=PACKED_WINDOW)),
                       ("packed window", dict(window=PACKED_WINDOW,
                                              seg=path_seg))):
        for name, times in _flash_times(randn, pbh, t, d, True,
                                        **forms).items():
            rec[name]["per_shape"]["%s %s" % (tag, times.pop("shape"))] = \
                times
    for tag, n, tq, t_, pos in (
            ("gpt2 decode", DECODE_BATCH * GPT2_HEADS, 1, T_MAX,
             DECODE_PROMPT + DECODE_NEW - 1),
            ("llama decode (GQA fold)", LLAMA_DECODE_BATCH * 4,
             LLAMA_HEADS // 4, LLAMA_LEN,
             LLAMA_DECODE_PROMPT + LLAMA_DECODE_NEW - 1)):
        times = _flash_decode_times(randn, n, tq, t_, d, pos)
        rec["flash_attention_fwd"]["per_shape"][
            "%s %s" % (tag, times.pop("shape"))] = times
    for name, e in (("flash_attention_fwd", "fwd"), ("flash_attention_dq", "dq"),
                    ("flash_attention_dkv", "dkv")):
        rec[name].update(max_abs_err=err_abs[e], max_rel_err=err[e])
    torch.cuda.synchronize()
    return rec


def _flash_decode_times(randn, bh, tq, tk, d, pos):
    """The flash forward at a one-token decode step's shape: q [BH, Tq,
    d] over the whole cache k/v [BH, Tk, d] with decode_pos_mask's key
    bias (0 up to `pos`, -1e30 beyond), beside the plain version and
    scaled_dot_product_attention with the bias as its additive mask.
    The kernel reads every key: the bias, not the tiles, masks the
    cache's tail; the bound counts the same."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (flash_attention_fwd,
                                          flash_attention_plain)

    q, k, v = randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d)
    kb = torch.zeros(bh, tk, device=q.device)
    kb[:, pos + 1:] = -1e30
    scale = d ** -0.5
    b, fl = _bound_ms(4 * (2 * bh * tq * d + 2 * bh * tk * d + bh * tk
                           + bh * tq), 4 * bh * tq * tk * d)
    return dict(
        shape="q [%d, %d, %d], k/v [%d, %d, %d], key bias to %d" % (
            bh, tq, d, bh, tk, d, pos),
        ms=_time_ms(lambda: flash_attention_fwd(q, k, v, kb, False, scale)),
        plain_ms=_time_ms(lambda: flash_attention_plain(q, k, v, kb, False,
                                                        scale)),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=kb[:, None, :], scale=scale)),
        bound_ms=b, bound_by=fl)


def _visible(t, causal, window=0, seg=None, dev=None):
    """[BH or 1, T, T] bool: the (query, key) pairs the causal mask, the
    window and the segment ids leave visible."""
    import torch

    pos = torch.arange(t, device=dev if seg is None else seg.device)
    gap = pos[:, None] - pos[None, :]
    vis = (gap >= 0) if causal else torch.ones_like(gap, dtype=torch.bool)
    if window:
        vis = vis & (gap < window)
    vis = vis[None]
    if seg is not None:
        vis = vis & (seg[:, :, None] == seg[:, None, :])
    return vis


def _flash_times(randn, bh, t, d, causal=True, window=0, seg=None):
    """Times of the three flash-attention kernels at one shape, causal or
    (BERT's form) with a key-padding bias masking the last quarter of
    the keys, with an optional window and segment ids [BH, T], beside
    the plain version and scaled_dot_product_attention with the same
    mask (the boolean mask of the visible pairs, the key bias added).
    The bound counts the visible pairs only: the kernels skip the tiles
    outside the causal band and the window, not those of other
    segments."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_fwd,
        flash_attention_grad_plain,
        flash_attention_plain,
    )

    q, k, v, do = (randn(bh, t, d) for _ in range(4))
    scale = d ** -0.5
    kb = mask = None
    if not causal:
        kb = torch.zeros(bh, t, device=q.device)
        kb[:, t - t // 4:] = -1e9
        mask = kb[:, None, :]
    forms = dict(window=window, seg=seg)
    if window or seg is not None:
        vis = _visible(t, causal, window, seg, q.device)
        mask = (vis if kb is None else torch.where(
            vis, kb[:, None, :], torch.full((), float("-inf"),
                                            device=q.device)))
        pairs = int(vis.sum()) * (bh if vis.shape[0] == 1 else 1)
    else:
        # the causal half the kernels compute, or every (query, key) pair
        pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    o, lse = flash_attention_fwd(q, k, v, kb, causal, scale, **forms)
    delta = (do * o).sum(-1)
    qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))

    def library(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask, is_causal=causal and mask is None)

    def library_fwd_bwd():
        return torch.autograd.grad(library(qg, kg, vg), (qg, kg, vg), do)

    plain_grad = _events_ms(lambda: flash_attention_grad_plain(
        q, k, v, kb, lse, do, delta, causal, scale, None, window, seg))
    lib_fwd_bwd = _events_ms(library_fwd_bwd)
    row = 4 * bh * t * d  # bytes of one [BH, T, d] operand
    bias = 0 if causal else 4 * bh * t  # the key bias (and dkbias) bytes
    bias += 0 if seg is None else 4 * bh * t  # the int32 segment ids
    specs = (
        ("flash_attention_fwd",
         lambda: flash_attention_fwd(q, k, v, kb, causal, scale, **forms),
         lambda: flash_attention_plain(q, k, v, kb, causal, scale, None,
                                       window, seg),
         lambda: library(q, k, v),
         4 * row + 4 * bh * t + bias, 4 * pairs * d),
        ("flash_attention_dq",
         lambda: flash_attention_dq(q, k, v, kb, lse, do, delta, causal,
                                    scale, **forms), None, None,
         5 * row + 8 * bh * t + bias, 6 * pairs * d),
        ("flash_attention_dkv",
         lambda: flash_attention_dkv(q, k, v, kb, lse, do, delta, causal,
                                     scale, **forms), None, None,
         6 * row + 8 * bh * t + bias + (0 if causal else 4 * bh * t),
         8 * pairs * d),
    )
    what = "causal" if causal else "key-padding bias"
    if window:
        what += ", window %d" % window
    if seg is not None:
        what += ", packed segment ids (%d visible pairs of %d)" % (
            pairs, bh * t * t)
    out = {}
    for name, kern, plain, lib, nbytes, flops in specs:
        b, fl = _bound_ms(nbytes, flops)
        out[name] = dict(
            shape="q, k, v [%d, %d, %d], %s%s" % (
                bh, t, d, what,
                "" if plain else
                "; plain_ms is the plain backward (dq, dk and dv together), "
                "library_ms scaled_dot_product_attention forward and "
                "backward"),
            ms=_time_ms(kern, reps=5, inner=5),
            plain_ms=_time_ms(plain, reps=5, inner=5) if plain else plain_grad,
            library_ms=_time_ms(lib, reps=5, inner=5) if lib else lib_fwd_bwd,
            bound_ms=b, bound_by=fl)
    return out


def _first_key(p, window):
    """The first key a query at global position p sees: 0, or under a
    window the first of its last `window` positions."""
    return max(0, p - window + 1) if window else 0


def _pairs(tq, tk, qbases, window=0):
    """Causal (query, key) pairs a based attention computes: query i of a
    row with base b sees keys _first_key(b + i) .. min(Tk - 1, b + i)."""
    return sum(sum(max(0, min(tk, b + i + 1) - _first_key(b + i, window))
                   for i in range(tq)) for b in qbases)


def _based_bounds(bh, tq, tk, d, qbases, window=0):
    """(fwd, dq, dkv) bound records of the based kernels over rows whose
    query bases are `qbases` (one per row): bytes of q, o (or do, dq),
    lse and delta, and of the keys each row needs (dk and dv are written
    whole), against 4, 6 and 8 flops per pair and head-dim column."""
    pairs = _pairs(tq, tk, qbases, window)
    keys = sum(max(0, min(tk, b + tq) - _first_key(b, window))
               for b in qbases)  # needed K/V rows
    qrow, krow = 4 * tq * d, 4 * d
    fwd = _bound_ms(2 * bh * qrow + 2 * keys * krow + 4 * bh * tq,
                    4 * pairs * d)
    dq = _bound_ms(3 * bh * qrow + 2 * keys * krow + 8 * bh * tq,
                   6 * pairs * d)
    dkv = _bound_ms(2 * bh * qrow + 2 * keys * krow + 2 * bh * tk * krow
                    + 8 * bh * tq, 8 * pairs * d)
    return fwd, dq, dkv


def check_attention_pieces(dev, randn):
    """flash_attention_piece (B9: the based forward, dq and dk/dv kernels
    with one offset for every row) and flash_attention_qvec's backward
    (B8: the based dq and dk/dv with a base per row) against their plain
    versions on the card.  B9's forward (o and lse) at the GPT-2 chunked
    prefill's shape (q [48, 64, 64] over k/v [48, 1024, 64], qoff 0, 192,
    960), at the TinyLlama-width chunk's (q [64, 128, 64] over [64, 2048,
    64], qoff 0, 128, 1920) and a ragged one (q [6, 37, 64] over [6, 1000,
    64], qoff 500); its backward with nonzero cotangents on o and lse at
    ring-like shapes (Tq = Tk = 1024, BH 48, qoff 0: the diagonal chunk;
    qoff 1024: off-diagonal, every key visible) and at the prefill shape;
    B8's backward at the serving shape (q [96, 16, 64], k/v [96, 1024,
    64], mixed per-row bases), its forward's lse included; B9 with window
    256 at the ring shapes (qoff 0 and 1024: there the rows from 255 on
    see no key and must keep the lse sentinel and zero dq) and at the
    prefill chunk (qoff 192 and 960, the cache's last chunk).  Limits as the B3 rows: 1e-4 of
    the largest magnitude of o (of the rows that see a key), dq, dk and
    dv, 1e-4 absolute on the lse; every rerun bit-equal.  Timed with
    CUDA events beside the plain version and
    scaled_dot_product_attention with the same boolean mask."""
    import importlib

    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (
        flash_attention_grad_plain,
        flash_attention_piece,
        flash_attention_piece_dkv,
        flash_attention_piece_dq,
        flash_attention_piece_fwd,
        flash_attention_piece_grad_plain,
        flash_attention_piece_plain,
        flash_attention_plain,
        flash_attention_qvec,
        flash_attention_qvec_dkv,
        flash_attention_qvec_dq,
    )

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    d = GPT2_D // GPT2_HEADS
    scale = d ** -0.5
    err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "qvec_dq": 0.0,
           "qvec_dkv": 0.0}
    err_abs = dict(err)

    def note(key, got, want):
        assert bool(torch.isfinite(got).all()), ("not finite", key)
        err[key] = max(err[key], ((got - want).abs().max()
                                  / want.abs().max().clamp_min(1e-30)).item())
        err_abs[key] = max(err_abs[key], (got - want).abs().max().item())

    def same(a, b):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), "rerun differs"

    pre_bh = DECODE_BATCH * GPT2_HEADS  # 48
    llama_bh = LLAMA_DECODE_BATCH * LLAMA_HEADS  # 64
    for bh, tq, tk, qoffs in ((pre_bh, DECODE_WIDTH, T_MAX, (0, 192, 960)),
                              (llama_bh, LLAMA_DECODE_WIDTH, LLAMA_LEN,
                               (0, 128, 1920)),
                              (6, 37, 1000, (500,))):
        q, k, v = randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d)
        for off in qoffs:
            qoff = torch.tensor([off], device=dev)
            o, lse = flash_attention_piece_fwd(q, k, v, True, scale, qoff)
            p_o, p_lse = flash_attention_piece_plain(q, k, v, True, scale,
                                                     qoff)
            note("fwd", o, p_o)
            assert (lse - p_lse).abs().max().item() <= 1e-4, ("lse", bh, off)
            same((o, lse), flash_attention_piece_fwd(q, k, v, True, scale,
                                                     qoff))
    for bh, tq, tk, off in ((pre_bh, T_MAX, T_MAX, 0),
                            (pre_bh, T_MAX, T_MAX, T_MAX),
                            (pre_bh, DECODE_WIDTH, T_MAX, 192)):
        q, k, v, do = randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d), \
            randn(bh, tq, d)
        dlse = randn(bh, tq)
        qoff = torch.tensor([off], device=dev)
        o, lse = flash_attention_piece_fwd(q, k, v, True, scale, qoff)
        _, vjp = torch.func.vjp(
            lambda a, b, c: flash_attention_piece(a, b, c, True, scale, qoff),
            q, k, v)
        grads = vjp((do, dlse))
        want = flash_attention_piece_grad_plain(q, k, v, o, lse, do, dlse,
                                                True, scale, qoff)
        note("dq", grads[0], want[0])
        note("dkv", grads[1], want[1])
        note("dkv", grads[2], want[2])
        same(grads, vjp((do, dlse)))
    # B9 with a window (the ring's, in global positions) at the ring
    # shapes, qoff 0 and 1024 (there the rows from 255 on see no key:
    # they keep the lse sentinel and take zero gradients; their o is
    # defined-garbage and not compared), and at the GPT-2 prefill chunk
    win = PACKED_WINDOW
    for bh, tq, tk, off in ((pre_bh, T_MAX, T_MAX, 0),
                            (pre_bh, T_MAX, T_MAX, T_MAX),
                            (pre_bh, DECODE_WIDTH, T_MAX, 192),
                            (pre_bh, DECODE_WIDTH, T_MAX,
                             T_MAX - DECODE_WIDTH)):
        q, k, v, do = randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d), \
            randn(bh, tq, d)
        dlse = randn(bh, tq)
        qoff = torch.tensor([off], device=dev)
        live = off + torch.arange(tq, device=dev) - (tk - 1) < win
        o, lse = flash_attention_piece_fwd(q, k, v, True, scale, qoff, win)
        p_o, p_lse = flash_attention_piece_plain(q, k, v, True, scale, qoff,
                                                 win)
        note("fwd", o[:, live], p_o[:, live])
        assert (lse - p_lse)[:, live].abs().max().item() <= 1e-4, (
            "window lse", off)
        assert bool((lse[:, ~live] <= fa.NEG_INF / 2).all()), "sentinel"
        assert bool((~live).any()) == (off == T_MAX)
        same((o, lse), flash_attention_piece_fwd(q, k, v, True, scale, qoff,
                                                 win))
        _, vjp = torch.func.vjp(
            lambda a, b, c: flash_attention_piece(a, b, c, True, scale, qoff,
                                                  win), q, k, v)
        grads = vjp((do, dlse))
        want = flash_attention_piece_grad_plain(q, k, v, o, lse, do, dlse,
                                                True, scale, qoff, win)
        note("dq", grads[0], want[0])
        note("dkv", grads[1], want[1])
        note("dkv", grads[2], want[2])
        assert grads[0][:, ~live].abs().sum().item() == 0.0, "dead-row dq"
        same(grads, vjp((do, dlse)))
    heads = GPT2_HEADS
    slot_q = [0, 500, T_MAX - WIDTH, 37, 0, 250, 983, 1]
    bh = N_SLOTS * heads
    qs = torch.tensor(slot_q, device=dev).repeat_interleave(heads)
    q, k, v, do = randn(bh, WIDTH, d), randn(bh, T_MAX, d), \
        randn(bh, T_MAX, d), randn(bh, WIDTH, d)
    o, lse = fa._qvec_forward(q, k, v, qs, scale, True)
    p_o, p_lse = flash_attention_plain(q, k, v, None, True, scale, qs)
    note("fwd", o, p_o)
    assert (lse - p_lse).abs().max().item() <= 1e-4, "qvec lse"
    assert torch.equal(o, flash_attention_qvec(q, k, v, qs, scale)), (
        "the lse output changed the serving forward's bits")
    _, vjp = torch.func.vjp(
        lambda a, b, c: flash_attention_qvec(a, b, c, qs, scale), q, k, v)
    grads = vjp(do)
    want = flash_attention_grad_plain(q, k, v, None, p_lse, do,
                                      (do * p_o).sum(-1), True, scale, qs)
    note("qvec_dq", grads[0], want[0])
    note("qvec_dkv", grads[1], want[1])
    note("qvec_dkv", grads[2], want[2])
    same(grads, vjp(do))
    for key, val in err.items():
        assert val <= 1e-4, ("based flash attention disagrees", key, val)

    rec = {}
    for name, site, e in (
            ("flash_attention_piece_fwd", ":279", "fwd"),
            ("flash_attention_piece_dq", ":447", "dq"),
            ("flash_attention_piece_dkv", ":471", "dkv"),
            ("flash_attention_qvec_dq", ":447", "qvec_dq"),
            ("flash_attention_qvec_dkv", ":471", "qvec_dkv")):
        rec[name] = dict(
            route="cuda",
            source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py" + site,
            max_abs_err=err_abs[e], max_rel_err=err[e])

    def piece_times(bh, tq, tk, off, window=0):
        q, k, v, do = (randn(bh, n, d) for n in (tq, tk, tk, tq))
        dlse = randn(bh, tq)
        qoff = torch.tensor([off], device=dev)
        o, lse = flash_attention_piece_fwd(q, k, v, True, scale, qoff, window)
        delta = (do * o).sum(-1) - dlse
        gap = (off + torch.arange(tq, device=dev)[:, None]
               - torch.arange(tk, device=dev)[None, :])
        mask = (gap >= 0) & ((gap < window) if window else True)
        qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
        fwd_b, dq_b, dkv_b = _based_bounds(bh, tq, tk, d, [off] * bh, window)
        shape = "q [%d, %d, %d], k/v [%d, %d, %d], qoff %d%s" % (
            bh, tq, d, bh, tk, d, off,
            ", window %d" % window if window else "")
        bwd_note = ("; plain_ms is the plain backward (dq, dk and dv "
                    "together), library_ms scaled_dot_product_attention "
                    "forward and backward")
        plain_bwd = _events_ms(lambda: flash_attention_piece_grad_plain(
            q, k, v, o, lse, do, dlse, True, scale, qoff, window))
        lib_bwd = _events_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                           scale=scale), (qg, kg, vg), do))
        return {
            "flash_attention_piece_fwd": dict(
                shape=shape,
                ms=_time_ms(lambda: flash_attention_piece_fwd(
                    q, k, v, True, scale, qoff, window), inner=5),
                plain_ms=_time_ms(lambda: flash_attention_piece_plain(
                    q, k, v, True, scale, qoff, window), inner=5),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale), inner=5),
                bound_ms=fwd_b[0], bound_by=fwd_b[1]),
            "flash_attention_piece_dq": dict(
                shape=shape + bwd_note,
                ms=_time_ms(lambda: flash_attention_piece_dq(
                    q, k, v, lse, do, delta, True, scale, qoff, window),
                    inner=5),
                plain_ms=plain_bwd, library_ms=lib_bwd,
                bound_ms=dq_b[0], bound_by=dq_b[1]),
            "flash_attention_piece_dkv": dict(
                shape=shape + bwd_note,
                ms=_time_ms(lambda: flash_attention_piece_dkv(
                    q, k, v, lse, do, delta, True, scale, qoff, window),
                    inner=5),
                plain_ms=plain_bwd, library_ms=lib_bwd,
                bound_ms=dkv_b[0], bound_by=dkv_b[1])}

    # the GPT-2 path's chunk is the forward's row; the ring's diagonal
    # chunk the backward's (no path of the repo runs it yet)
    for tag, args in (("gpt2 prefill", (pre_bh, DECODE_WIDTH, T_MAX, 192)),
                      ("llama prefill", (llama_bh, LLAMA_DECODE_WIDTH,
                                         LLAMA_LEN, 128)),
                      ("ring diagonal", (pre_bh, T_MAX, T_MAX, 0)),
                      ("ring off-diagonal", (pre_bh, T_MAX, T_MAX, T_MAX)),
                      ("ring diagonal window", (pre_bh, T_MAX, T_MAX, 0,
                                                PACKED_WINDOW)),
                      ("gpt2 prefill window", (pre_bh, DECODE_WIDTH, T_MAX,
                                               T_MAX - DECODE_WIDTH,
                                               PACKED_WINDOW))):
        for name, times in piece_times(*args).items():
            main_row = (tag == "gpt2 prefill" if name.endswith("fwd")
                        else tag == "ring diagonal")
            if main_row:
                rec[name].update(times)
            else:
                rec[name].setdefault("per_shape", {})[
                    "%s %s" % (tag, times.pop("shape"))] = times

    delta = (do * o).sum(-1)
    mask = (qs[:, None, None] + torch.arange(WIDTH, device=dev)[None, :, None]
            >= torch.arange(T_MAX, device=dev)[None, None, :])
    qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
    _, dq_b, dkv_b = _based_bounds(bh, WIDTH, T_MAX, d, qs.tolist())
    plain_bwd = _events_ms(lambda: flash_attention_grad_plain(
        q, k, v, None, lse, do, delta, True, scale, qs))
    lib_bwd = _events_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                       scale=scale), (qg, kg, vg), do))
    shape = ("q [%d, %d, %d], k/v [%d, %d, %d], per-row bases %s x %d "
             "heads; plain_ms is the plain backward (dq, dk and dv "
             "together), library_ms scaled_dot_product_attention forward "
             "and backward" % (bh, WIDTH, d, bh, T_MAX, d, slot_q, heads))
    for name, fn, b in (
            ("flash_attention_qvec_dq", lambda: flash_attention_qvec_dq(
                q, k, v, lse, do, delta, qs, scale), dq_b),
            ("flash_attention_qvec_dkv", lambda: flash_attention_qvec_dkv(
                q, k, v, lse, do, delta, qs, scale), dkv_b)):
        rec[name].update(shape=shape, ms=_time_ms(fn, inner=5),
                         plain_ms=plain_bwd, library_ms=lib_bwd,
                         bound_ms=b[0], bound_by=b[1])
    torch.cuda.synchronize()
    return rec


def _serve_on_card(label, hp, t_max, per_step, seed):
    """One serving path on the card: `hp` with random weights from `seed`
    through ServingEngine(n_slots=8, width=16, t_max), the seeded
    24-request Poisson trace, every launch count reset just before and
    read just after and held to `per_step` times the engine's steps;
    every request OK with its full budget, a greedy and a sampled request
    equal to their run_solo bit for bit.  Returns (launches, eng,
    scope)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import gpt2
    from paddle_tpu_torch.serving import ServingEngine, make_poisson_trace

    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CUDAPlace(0))
        _, startup, _, _ = gpt2.gpt2_logits_program(hp, seq_len=t_max)
        startup.random_seed = seed
        exe.run(startup)
        eng = ServingEngine(exe, hp, n_slots=N_SLOTS, width=WIDTH, t_max=t_max)
        trace = make_poisson_trace(24, rate=0.5, prompt_len_range=(16, 384),
                                   out_len_range=(16, 64),
                                   vocab_size=hp.vocab_size, seed=0)
        kernels.reset_launch_counts()
        results, stats = eng.run(trace)
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        steps = stats["steps"]
        for name, n in per_step.items():
            assert launches[name] == n * steps, (
                "launch count", label, name, launches[name], n, steps)
        for r in trace:
            res = results[r.rid]
            assert res["status"] == "OK", (r.rid, res["status"])
            toks = res["tokens"]
            assert toks.size == r.max_new_tokens, (r.rid, toks.size)
            assert ((toks >= 0) & (toks < hp.vocab_size)).all(), r.rid
        greedy = next(r for r in trace if r.greedy)
        sampled = next(r for r in trace if not r.greedy)
        for r in (greedy, sampled):
            solo, _ = eng.run_solo(r)
            assert np.array_equal(solo, results[r.rid]["tokens"]), (
                "pooled != solo", label, r.rid)
        print("served %s: %d requests in %d steps: %.1f tokens/s, step p50 "
              "%.3f ms, mean %.3f ms; pooled == solo for rid %d (greedy) and "
              "%d (sampled); launches %s" % (
                  label, len(trace), steps, stats["tokens_per_s"],
                  stats["step_s_p50"] * 1e3, stats["step_s_mean"] * 1e3,
                  greedy.rid, sampled.rid, json.dumps(launches)))
    return launches, eng, scope


def serve_gpt2_small(dev):
    """The first serving path: GPT-2 small served through the engine on
    the card, t_max 1024."""
    from paddle_tpu_torch.models import gpt2

    hp = gpt2.GPT2Config
    return _serve_on_card(
        "GPT-2 small", hp, T_MAX,
        {"flash_attention_qvec": hp.n_layer,
         "matmul_bias_act": 2 * hp.n_layer,
         "fused_add_layer_norm": 2 * hp.n_layer + 1}, 1234)


def serve_tinyllama(dev):
    """The modern-decoder serving path at TinyLlama-1.1B's widths, t_max
    2048.  Per engine step: matmul_swiglu and matmul_bias_act (ffn_out)
    once per layer, flash_attention_qvec once per layer, add-LN twice per
    layer, and one plain layer norm: under rotary no position add
    precedes block 0's first norm."""
    hp = tinyllama_config()
    return _serve_on_card(
        "TinyLlama-1.1B widths", hp, hp.n_ctx,
        {"matmul_swiglu": 22, "matmul_bias_act": 22,
         "flash_attention_qvec": 22, "fused_add_layer_norm": 44,
         "fused_layer_norm": 1}, 1235)


def _profile_report(prof, wall_us, steps, name, out_dir):
    """Device busy share, device time by kernel, torch calls and host time
    by span from one torch.profiler window of `steps` steps; written to
    out_dir/profile_<name>.json and summarized."""
    from torch.autograd import DeviceType

    device, spans = {}, {}
    busy = []
    torch_calls = 0  # aten ops entered from Python, not from another op
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("aten::"):
            parent = e.cpu_parent
            torch_calls += not (parent and parent.name.startswith("aten::"))
        dur = e.time_range.end - e.time_range.start
        span = e.name.startswith(("serve_", "executor_run", "feed_upload",
                                  "op_grad"))
        if e.device_type == DeviceType.CUDA:
            # the spans are mirrored onto the device timeline as
            # annotations; only kernels and copies count as busy
            if span or getattr(e, "is_user_annotation", False):
                continue
            device[e.name] = device.get(e.name, 0.0) + dur
            busy.append((e.time_range.start, e.time_range.end))
        elif span:
            spans[e.name] = spans.get(e.name, 0.0) + dur
    busy.sort()
    busy_us, end = 0.0, float("-inf")
    for s, e in busy:  # union of device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    top = sorted(device.items(), key=lambda kv: -kv[1])
    report = {
        "steps": steps, "wall_us": wall_us, "device_busy_us": busy_us,
        "device_idle_share": (1.0 - busy_us / wall_us) if busy_us else None,
        "torch_calls": torch_calls, "host_spans_us": spans,
        "device_us_by_kernel": dict(top),
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "profile_%s.json" % name)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print("profile %s: %d steps, wall %.1f ms/step, device busy %.1f ms/step, "
          "%.0f torch calls/step, idle share %s; written to %s" % (
              name, steps, wall_us / 1e3 / steps, busy_us / 1e3 / steps,
              torch_calls / steps,
              "not measured (no device events)" if not busy_us
              else "%.3f" % report["device_idle_share"], path))
    print("profile %s host spans (ms/step): %s" % (name, json.dumps(
        {k: v / 1e3 / steps for k, v in sorted(spans.items())})))
    print("profile %s device top 12 (ms/step): %s" % (name, json.dumps(
        {k[:70]: v / 1e3 / steps for k, v in top[:12]})))


def profile_serving(eng, scope, out_dir, name="serving"):
    """Where the serving step's time goes: a torch.profiler trace of a
    short seeded trace through the same engine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.serving import make_poisson_trace

    trace = make_poisson_trace(6, rate=0.5, prompt_len_range=(16, 384),
                               out_len_range=(16, 64),
                               vocab_size=eng.hp.vocab_size, seed=1)
    with ptt.scope_guard(scope):
        eng.run(trace[:1])  # warm the allocator outside the window
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, stats = eng.run(trace)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    _profile_report(prof, wall_us, stats["steps"], name, out_dir)


def profile_training(run_step, out_dir, steps=3, name="training"):
    """Where a training step's time goes: `steps` steps of the same
    program under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _profile_report(prof, wall_us, steps, name, out_dir)


def narrow_gpt2_config():
    """A narrow GPT-2 for serving card vs CPU: vocab 97, n_ctx 64, d_model
    128, 2 layers, 2 heads of 64 (the kernels' head width)."""
    from paddle_tpu_torch.models import gpt2

    class Narrow(gpt2.GPT2Config):
        vocab_size, n_ctx, d_model, n_layer, n_head = 97, 64, 128, 2, 2

    return Narrow


def card_matches_cpu(dev, n_slots, Narrow, must_launch):
    """The narrow config `Narrow` served on the card and on the CPU plain
    path with the same weights: logits of every step agree, and the
    card's run launched each kernel of `must_launch`."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import gpt2
    from paddle_tpu_torch.serving import ServingEngine, make_poisson_trace

    logits = {}
    for kind in ("cpu", "cuda"):
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            place = ptt.CPUPlace() if kind == "cpu" else ptt.CUDAPlace(0)
            exe = ptt.Executor(place)
            _, startup, _, _ = gpt2.gpt2_logits_program(Narrow, seq_len=48)
            if kind == "cpu":
                startup.random_seed = 5
                exe.run(startup)
                weights = {n: scope.find_var(n).clone()
                           for n in scope.local_var_names()}
            else:
                for n, w in weights.items():
                    scope.set(n, w.to(dev))
            eng = ServingEngine(exe, Narrow, n_slots=n_slots, width=4,
                                t_max=48)
            seen = logits[kind] = []
            run = exe.run

            def recording(program=None, feed=None, fetch_list=None, **kw):
                out = run(program, feed=feed, fetch_list=fetch_list, **kw)
                if program is eng.step_main:
                    seen.append(out[0])
                return out

            exe.run = recording
            trace = make_poisson_trace(5, rate=0.7, prompt_len_range=(2, 20),
                                       out_len_range=(4, 9),
                                       vocab_size=Narrow.vocab_size, seed=3,
                                       sampled_fraction=0.0)
            kernels.reset_launch_counts()
            eng.run(trace)
    launched = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    assert all(launched[n] for n in must_launch), (
        "a kernel did not launch", launched)
    assert len(logits["cpu"]) == len(logits["cuda"]) > 0
    err = 0.0
    for a, b in zip(logits["cpu"], logits["cuda"]):
        assert b.shape == a.shape and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
        err = max(err, float(np.abs(b - a).max()))
    print("%s, %d slot(s), on the card vs the CPU plain path: %d "
          "steps, max abs logit difference %.3g, launches %s" % (
              Narrow.__name__, n_slots,
              len(logits["cpu"]), err, json.dumps(launched)))


def _expected_train_launches(main):
    """Kernel launches per training step, read off the program: each
    fused op launches its kernel once, and its grad op once more (the
    grad re-runs the forward rule under torch.func.vjp); the linear
    cross entropy's grad also launches dx and dw, fused_attention's grad
    dq and dk/dv, and the grad of a softmax_with_cross_entropy of the
    kernel form the softmax cross-entropy backward; padded_lstm and
    padded_gru launch theirs in the forward direction only.  In the training
    programs every layer_norm is the kernel form (last axis, Scale and
    Bias) and no fused_attention has a QStart: its window and segment-id
    forms launch the same three flash kernels."""
    from paddle_tpu_torch.ops.math_ops import softmax_xent_kernel_form

    block = main.global_block()
    ops = [op.type for op in block.ops]
    sxent = [op.type for op in block.ops
             if op.type.startswith("softmax_with_cross_entropy")
             and softmax_xent_kernel_form(
                 op.attrs.get("__fwd_attrs__", op.attrs),
                 len(block.vars[op.inputs["Logits"][0]].shape))]
    return {
        "matmul_bias_act": ops.count("fc") + ops.count("fc_grad"),
        "fused_add_layer_norm": (ops.count("fused_residual_ln")
                                 + ops.count("fused_residual_ln_grad")),
        "linear_xent_fwd": (ops.count("fused_linear_xent")
                            + ops.count("fused_linear_xent_grad")),
        "linear_xent_dx": ops.count("fused_linear_xent_grad"),
        "linear_xent_dw": ops.count("fused_linear_xent_grad"),
        "flash_attention_qvec": 0,
        "fused_layer_norm": (ops.count("layer_norm")
                             + ops.count("layer_norm_grad")),
        "flash_attention_fwd": (ops.count("fused_attention")
                                + ops.count("fused_attention_grad")),
        "flash_attention_dq": ops.count("fused_attention_grad"),
        "flash_attention_dkv": ops.count("fused_attention_grad"),
        "matmul_swiglu": (ops.count("fused_swiglu")
                          + ops.count("fused_swiglu_grad")),
        "softmax_xent_fwd": len(sxent),
        "softmax_xent_bwd": sxent.count("softmax_with_cross_entropy_grad"),
        "fused_lstm": _forward_recurrent(block, "padded_lstm"),
        "fused_gru": _forward_recurrent(block, "padded_gru"),
    }


def _forward_recurrent(block, op_type):
    """Ops of `op_type` and their grads in the forward direction: each
    launches its recurrent kernel once (the grad re-runs the forward
    rule; the backward itself is the plain scan's vjp).  The reverse
    direction is the reference's plain scan and launches nothing."""
    n = 0
    for op in block.ops:
        if op.type in (op_type, op_type + "_grad"):
            n += not op.attrs.get("__fwd_attrs__", op.attrs).get(
                "is_reverse", False)
    return n


def _train_on_card(label, main, startup, fetch, batch, n_tok, rows,
                   first_range, per_step, profile_dir, profile_name,
                   steps=TRAIN_STEPS, dropout=True, loss_parts=None):
    """One training path on the card: one warm-up step (its loss within
    `first_range`), then `steps` timed steps with every launch count
    reset just before and read just after and held to `per_step` times
    the steps; then the same step twice from one saved state (kept on
    the host), bit for bit, and, for a path with `dropout`, a step
    checking every dropout_grad against its forward op's mask.  fetch[1]
    is the step's token count, held to `n_tok`, unless `loss_parts`
    names fetch[1:] (BERT's MLM and NSP losses, the LSTM classifier's
    accuracy; none for a program that fetches its loss alone), which are
    then printed.  Prints the path's line (tokens/s counts
    `n_tok` a step, examples/s the batch's rows) and returns the launch
    counts."""
    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels

    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CUDAPlace(0))
        exe.run(startup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = float(exe.run(main, feed=batch, fetch_list=[fetch[0]])[0].sum())
        assert first_range[0] < first < first_range[1], (
            "first loss out of range", label, first, first_range)
        kernels.reset_launch_counts()
        losses, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(main, feed=batch, fetch_list=fetch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(out[0].sum()))
            if loss_parts is None:
                assert float(out[1].sum()) == n_tok
            else:
                parts = [float(v.sum()) for v in out[1:]]
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        peak = torch.cuda.max_memory_allocated()
        assert all(np.isfinite(losses)), losses
        if loss_parts:
            assert all(np.isfinite(parts)), parts
        for name, n in per_step.items():
            assert launches[name] == n * steps, (
                "launch count", label, name, launches[name], n, steps)

        # the same step twice from one saved state: a fresh executor each
        # time, so both draw the same dropout masks.  The state and the
        # first run's result wait on the host: at 1.1 B parameters three
        # device copies of the weights and Adam moments would not fit
        # beside the step.
        where = {n: scope.find_var(n).device for n in scope.local_var_names()}
        state = {n: scope.find_var(n).cpu() for n in where}
        first_run = None
        for _ in range(2):
            for n, v in state.items():
                scope.set(n, v.to(where[n]))
            loss = ptt.Executor(ptt.CUDAPlace(0)).run(
                main, feed=batch, fetch_list=[fetch[0]])[0]
            after = {n: scope.find_var(n).cpu() for n in state}
            if first_run is None:
                first_run = (loss, after)
        assert np.array_equal(first_run[0], loss), "loss not reproducible"
        differ = [n for n in state if not torch.equal(first_run[1][n],
                                                      after[n])]
        assert not differ, ("updated state not reproducible", differ[:5])
        moved = sum(not torch.equal(after[n], state[n]) for n in state)
        del first_run, after, state

        # each dropout_grad redraws its forward op's mask on the card: its
        # X@GRAD is Out@GRAD times the forward's Mask, bit for bit
        block = main.global_block()
        names = []
        for op in block.ops:
            if dropout and op.type == "dropout_grad":
                fwd = block.ops[op.attrs["__fwd_op_idx__"]]
                names += [fwd.outputs["Mask"][0], op.inputs["Out@GRAD"][0],
                          op.outputs["X@GRAD"][0]]
        assert names or not dropout, "no dropout_grad op"
        if names:
            vals = exe.run(main, feed=batch, fetch_list=names,
                           return_numpy=False)
            for i in range(0, len(vals), 3):
                mask, dout, dx = vals[i:i + 3]
                assert torch.equal(dx, dout * mask), ("dropout_grad mask",
                                                      names[i])
                assert 0.85 < float(mask.mean()) < 0.95, (names[i],
                                                          mask.mean())
            del vals
        if profile_dir:
            profile_training(lambda: exe.run(main, feed=batch,
                                             fetch_list=fetch), profile_dir,
                             name=profile_name)
    p50 = sorted(times)[len(times) // 2]
    examples = len(next(iter(batch.values())))
    print("trained %s %d steps: step p50 %.3f ms, mean %.3f ms; %.1f "
          "tokens/s (%d a step), %.1f rows/s, %.1f examples/s; losses %s "
          "(first %.4f)%s; peak memory %.2f GB; launches per step %s; one "
          "step from a saved state twice: bit-equal loss and %d updated state "
          "tensors; %d dropout_grad ops redrew their forward masks" % (
              label, steps, p50 * 1e3, sum(times) / len(times) * 1e3,
              n_tok / p50, n_tok, rows / p50, examples / p50,
              json.dumps([round(v, 6) for v in losses]), first,
              "; last step's %s" % ", ".join(
                  "%s %.6f" % kv for kv in zip(loss_parts, parts))
              if loss_parts else "", peak / 1e9,
              json.dumps({k: v // steps for k, v in launches.items()}),
              moved, len(names) // 3))
    return launches


def train_transformer_base(dev, profile_dir=None):
    """The WMT training path: Transformer-base (ModelHyperParams: vocab
    10000/10000, d_model 512, d_inner 2048, 8 heads, 6+6 layers, dropout
    0.1, label smoothing 0.1, noam lr, Adam) on batch 64 x 64 tokens,
    random weights from a seed, through _train_on_card."""
    from paddle_tpu_torch.models import transformer as tfm

    hp = tfm.ModelHyperParams
    main, startup, _, fetch = tfm.wmt_transformer_program(
        hp, src_len=TRAIN_LEN, trg_len=TRAIN_LEN)
    startup.random_seed = main.random_seed = 4321
    per_step = _expected_train_launches(main)
    assert per_step == {"matmul_bias_act": 48, "fused_add_layer_norm": 60,
                        "linear_xent_fwd": 2, "linear_xent_dx": 1,
                        "linear_xent_dw": 1, "flash_attention_qvec": 0,
                        "fused_layer_norm": 0, "flash_attention_fwd": 0,
                        "flash_attention_dq": 0,
                        "flash_attention_dkv": 0,
                        "matmul_swiglu": 0, "softmax_xent_fwd": 0,
                        "softmax_xent_bwd": 0, "fused_lstm": 0,
                        "fused_gru": 0}, per_step
    batch = tfm.make_fake_batch(TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN, hp, seed=0)
    return _train_on_card(
        "Transformer-base (batch %d x %d)" % (TRAIN_BATCH, TRAIN_LEN), main,
        startup, fetch, batch, float(batch["lbl_weight"].sum()), TRAIN_ROWS,
        (8.0, 10.5), per_step, profile_dir, "training")


def train_gpt2_small(dev, profile_dir=None):
    """The GPT-2 training path: gpt2_lm_program(GPT2Config) — vocab
    50257, n_ctx 1024, d_model 768, 12 layers, 12 heads, dropout 0.1,
    untied head, Adam lr 3e-4 — on make_fake_lm_batch(8, 1024, seed=0),
    random weights from a seed, through _train_on_card.  The first loss
    must be near ln 50257 = 10.82 (random weights at std 0.02 give
    near-uniform logits)."""
    import math

    from paddle_tpu_torch.models import gpt2

    hp = gpt2.GPT2Config
    main, startup, _, fetch = gpt2.gpt2_lm_program(hp, seq_len=GPT2_LEN)
    startup.random_seed = main.random_seed = 2024
    per_step = _expected_train_launches(main)
    assert per_step == {"matmul_bias_act": 48, "fused_add_layer_norm": 48,
                        "linear_xent_fwd": 2, "linear_xent_dx": 1,
                        "linear_xent_dw": 1, "flash_attention_qvec": 0,
                        "fused_layer_norm": 2, "flash_attention_fwd": 24,
                        "flash_attention_dq": 12,
                        "flash_attention_dkv": 12,
                        "matmul_swiglu": 0, "softmax_xent_fwd": 0,
                        "softmax_xent_bwd": 0, "fused_lstm": 0,
                        "fused_gru": 0}, per_step
    batch = gpt2.make_fake_lm_batch(GPT2_BATCH, GPT2_LEN, hp, seed=0)
    ln_v = math.log(hp.vocab_size)
    return _train_on_card(
        "GPT-2 small (batch %d x %d)" % (GPT2_BATCH, GPT2_LEN), main, startup,
        fetch, batch, float(batch["loss_weight"].sum()), GPT2_ROWS,
        (ln_v - 0.5, ln_v + 0.5), per_step, profile_dir, "training_gpt2")


def train_tinyllama(dev, profile_dir=None):
    """The modern-decoder training path at TinyLlama-1.1B's widths:
    gpt2_lm_program(tinyllama_config(), seq_len=2048) — rotary, SwiGLU
    (fused_swiglu on matmul_swiglu), grouped-query attention, dropout 0,
    Adam lr 3e-4 — on make_fake_lm_batch(2, 2048, seed=0), random weights
    from a seed, through _train_on_card (5 timed steps, no dropout
    masks to check).  The first loss must be within 0.5 of ln 32000 =
    10.37."""
    import math

    from paddle_tpu_torch.models import gpt2

    hp = tinyllama_config()
    main, startup, _, fetch = gpt2.gpt2_lm_program(hp, seq_len=LLAMA_LEN)
    startup.random_seed = main.random_seed = 2025
    assert main._swiglu_fused_count == hp.n_layer
    per_step = _expected_train_launches(main)
    assert per_step == {"matmul_bias_act": 44, "fused_add_layer_norm": 88,
                        "linear_xent_fwd": 2, "linear_xent_dx": 1,
                        "linear_xent_dw": 1, "flash_attention_qvec": 0,
                        "fused_layer_norm": 2, "flash_attention_fwd": 44,
                        "flash_attention_dq": 22,
                        "flash_attention_dkv": 22,
                        "matmul_swiglu": 44, "softmax_xent_fwd": 0,
                        "softmax_xent_bwd": 0, "fused_lstm": 0,
                        "fused_gru": 0}, per_step
    batch = gpt2.make_fake_lm_batch(LLAMA_BATCH, LLAMA_LEN, hp, seed=0)
    ln_v = math.log(hp.vocab_size)
    return _train_on_card(
        "TinyLlama-1.1B widths (batch %d x %d)" % (LLAMA_BATCH, LLAMA_LEN),
        main, startup, fetch, batch, float(batch["loss_weight"].sum()),
        LLAMA_ROWS, (ln_v - 0.5, ln_v + 0.5), per_step, profile_dir,
        "training_llama", steps=LLAMA_STEPS, dropout=False)


def _card_matches_cpu(label, main, startup, fetch, batch, must_launch):
    """A narrow program trained 3 steps from the same weights on the card
    and on the CPU plain path: every fetch (the loss, and BERT's MLM and
    NSP losses or the token count) agrees to 1e-5 relative, every launch
    count is 3 steps of what the program implies, and each of
    `must_launch` launched."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels

    losses = {}
    for kind in ("cpu", "cuda"):
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            place = ptt.CPUPlace() if kind == "cpu" else ptt.CUDAPlace(0)
            exe = ptt.Executor(place)
            if kind == "cpu":
                exe.run(startup)
                weights = {n: scope.find_var(n).clone()
                           for n in scope.local_var_names()}
            else:
                for n, w in weights.items():
                    scope.set(n, w.to(place.torch_device()))
            kernels.reset_launch_counts()
            losses[kind] = [[float(v.sum()) for v in exe.run(
                main, feed=batch, fetch_list=fetch)] for _ in range(3)]
    launched = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    want = _expected_train_launches(main)
    for name, n in want.items():
        assert launched[name] == 3 * n, ("launch count", name, launched)
    assert all(launched[n] for n in must_launch), launched
    assert np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    err = max(abs(a - b) / abs(b) for x, y in zip(losses["cuda"],
                                                   losses["cpu"])
              for a, b in zip(x, y))
    print("narrow %s trained 3 steps on the card vs the CPU plain path: "
          "losses %s vs %s, max relative difference %.3g, launches %s" % (
              label, losses["cuda"], losses["cpu"], err, json.dumps(launched)))


def train_card_matches_cpu(dev, fused_attn=False):
    """A narrow WMT Transformer (2+2 layers, dropout 0): d_model 64 with
    4 heads, or with `fused_attn` d_model 128 with 2 heads of 64 (the
    flash-attention kernels' width), whose attention is the flash
    kernels' causal and key-bias forms."""
    from paddle_tpu_torch.models import transformer as tfm

    class Narrow(tfm.ModelHyperParams):
        src_vocab_size = trg_vocab_size = 1000
        max_length, d_model, d_inner_hid, n_head, n_layer = 64, 64, 256, 4, 2
        dropout = 0.0

    class NarrowFused(Narrow):
        d_model, n_head, fused_attn = 128, 2, True

    hp = NarrowFused if fused_attn else Narrow
    main, startup, _, fetch = tfm.wmt_transformer_program(
        hp, src_len=16, trg_len=16)
    startup.random_seed = 7
    must = ("matmul_bias_act", "fused_add_layer_norm", "linear_xent_fwd",
            "linear_xent_dx", "linear_xent_dw")
    if fused_attn:
        must += GPT2_KERNELS[1:]  # flash attention forward, dq, dk/dv
    _card_matches_cpu("WMT" + (" fused_attn" if fused_attn else ""), main,
                      startup, fetch,
                      tfm.make_fake_batch(8, 16, 16, hp, seed=3), must)


def train_transformer_base_fused_attn(dev):
    """WMT's hp.fused_attn path at Transformer-base's widths, batch 64 x
    64, 1 + 3 steps through _train_on_card: every attention on the flash
    kernels (the encoder's and the cross attention's source key bias,
    the decoder's causal form with the target key bias), per step
    forward 36, dq 18 and dk/dv 18 launches beside B2, B4 and B5."""
    from paddle_tpu_torch.models import transformer as tfm

    class Fused(tfm.ModelHyperParams):
        fused_attn = True

    main, startup, _, fetch = tfm.wmt_transformer_program(
        Fused, src_len=TRAIN_LEN, trg_len=TRAIN_LEN)
    startup.random_seed = main.random_seed = 4322
    per_step = _expected_train_launches(main)
    assert per_step == {"matmul_bias_act": 48, "fused_add_layer_norm": 60,
                        "linear_xent_fwd": 2, "linear_xent_dx": 1,
                        "linear_xent_dw": 1, "flash_attention_qvec": 0,
                        "fused_layer_norm": 0, "flash_attention_fwd": 36,
                        "flash_attention_dq": 18,
                        "flash_attention_dkv": 18,
                        "matmul_swiglu": 0, "softmax_xent_fwd": 0,
                        "softmax_xent_bwd": 0, "fused_lstm": 0,
                        "fused_gru": 0}, per_step
    batch = tfm.make_fake_batch(TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN, Fused,
                                seed=0)
    return _train_on_card(
        "Transformer-base, fused_attn (batch %d x %d)" % (TRAIN_BATCH,
                                                          TRAIN_LEN),
        main, startup, fetch, batch, float(batch["lbl_weight"].sum()),
        TRAIN_ROWS, (8.0, 10.5), per_step, None, None, steps=3)


class TinyVocabParallelWMT:
    """The narrow WMT config of the CPU tests' vocab-parallel runs: vocab
    64, d_model 32, d_inner 64, 4 heads, 2+2 layers, dropout 0, batch 4 x
    8 (a subclass of ModelHyperParams is made where it is used)."""

    attrs = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16,
                 d_model=32, d_inner_hid=64, n_head=4, n_layer=2, dropout=0.0)
    batch, length = 4, 8


def _vp_program(hp, mesh, length):
    """The WMT training program with softmax_out.w vocab-sharded over `mesh`
    (the vocab-only rule table; None: unstamped), seed 4321."""
    from paddle_tpu_torch.models import transformer as tfm
    from paddle_tpu_torch.parallel import P, TrainPartitionRules, annotate_spmd

    main, startup, _, fetch = tfm.wmt_transformer_program(
        hp, src_len=length, trg_len=length, mesh=mesh)
    if mesh is not None:
        annotate_spmd(main, mesh, TrainPartitionRules(
            [(r"softmax_out\.w", P(None, "mp"))]))
    startup.random_seed = main.random_seed = 4321
    return main, startup, fetch


def _vocab_slab_names(names):
    """softmax_out.w and its Adam moments: the vocab-sharded persistables."""
    return sorted(n for n in names if n.startswith("softmax_out.w")
                  and "pow" not in n)


def _state_sums(scope, names):
    """One int per tensor: the sum of its float32 bit patterns, on the
    card (equal sums for bit-equal tensors)."""
    import torch

    return {n: int(scope.find_var(n).contiguous().view(torch.int32)
                   .to(torch.int64).sum()) for n in names}


def _vp_rank(rank, store, out_dir, profile_dir):
    """One rank of the vocab-parallel phase on cuda:0, on a gloo group
    named explicitly (NCCL refuses two ranks on one card).  Writes its
    results, or its traceback, to out_dir/rank<r>.pkl; the parent fails
    the phase on either a traceback or a nonzero exit."""
    import pickle
    import traceback

    path = os.path.join(out_dir, "rank%d.pkl" % rank)
    try:
        out = _vp_rank_run(rank, store, out_dir, profile_dir)
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump({"error": traceback.format_exc()}, f)
        raise
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _vp_rank_run(rank, store, out_dir, profile_dir):
    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.executor import gather_persistable
    from paddle_tpu_torch.models import transformer as tfm
    from paddle_tpu_torch.parallel import collective, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    collective.init_distributed_env("file://" + store, VP_MP, rank,
                                    backend="gloo")
    mesh = make_mesh({"dp": 1, "mp": VP_MP})
    hp = tfm.ModelHyperParams
    main, startup, fetch = _vp_program(hp, mesh, TRAIN_LEN)
    batch = tfm.make_fake_batch(TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN, hp, seed=0)
    out = {}
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CUDAPlace(0))
        exe.run(startup)
        names = scope.local_var_names()
        slabs = _vocab_slab_names(names)
        whole = [n for n in names if n not in slabs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the 2 warm-up steps and one more: the exactness steps
        out["losses"] = [float(exe.run(main, feed=batch, fetch_list=[fetch[0]])
                               [0].sum()) for _ in range(VP_WARMUP + 1)]
        w = gather_persistable(scope, main, slabs[0])
        if rank == 0:
            np.save(os.path.join(out_dir, "w_gathered.npy"), w.cpu().numpy())
        out["held"] = {n: tuple(scope.find_var(n).shape) for n in slabs}
        out["sums_exact"] = _state_sums(scope, whole)
        kernels.reset_launch_counts()
        times = []
        for _ in range(VP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = exe.run(main, feed=batch, fetch_list=fetch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            assert float(loss[1].sum()) == float(batch["lbl_weight"].sum())
            out["losses"].append(float(loss[0].sum()))
        out["launches"] = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        out["times"] = times
        out["peak"] = torch.cuda.max_memory_allocated()
        out["sums_last"] = _state_sums(scope, whole)
        if profile_dir:
            # rank 0's process under the profiler (its own kernels: the
            # idle share counts the card's time with rank 1 as idle); rank
            # 1 runs the same 1 + 3 steps, so the collectives pair up
            def step():
                exe.run(main, feed=batch, fetch_list=fetch)

            if rank == 0:
                profile_training(step, profile_dir,
                                 name="training_vocab_parallel")
            else:
                for _ in range(4):
                    step()
    del scope, exe
    torch.cuda.empty_cache()

    # the narrow config on the card's two ranks and on the CPU's (the same
    # gloo group, CPU tensors): 3 steps each from the same weights
    narrow = type("NarrowVP", (hp,), TinyVocabParallelWMT.attrs)
    n_batch = tfm.make_fake_batch(TinyVocabParallelWMT.batch,
                                  TinyVocabParallelWMT.length,
                                  TinyVocabParallelWMT.length, narrow, seed=0)
    out["narrow"] = {}
    for kind in ("cpu", "cuda"):
        main, startup, fetch = _vp_program(narrow, mesh,
                                           TinyVocabParallelWMT.length)
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            place = ptt.CPUPlace() if kind == "cpu" else ptt.CUDAPlace(0)
            exe = ptt.Executor(place)
            if kind == "cpu":
                exe.run(startup)
                weights = {n: scope.find_var(n).clone()
                           for n in scope.local_var_names()}
            else:
                for n, v in weights.items():
                    scope.set(n, v.to(place.torch_device()))
            out["narrow"][kind] = [float(exe.run(
                main, feed=n_batch, fetch_list=[fetch[0]])[0].sum())
                for _ in range(3)]
    collective.barrier()
    return out


def train_vocab_parallel(dev, smi, profile_dir=None):
    """Transformer-base (the WMT program of train_transformer_base, seed
    4321, batch 64 x 64) on a {"dp": 1, "mp": 2} mesh whose rule table
    vocab-shards softmax_out.w: two ranks on cuda:0 over gloo, each
    holding the [512, 5000] slab of its mp coordinate and running
    sharded_linear_xent's kernels.  First a one-process unsharded run of
    the same program, weights and batch (3 steps); then the ranks run 2
    warm-up steps and one more (the three exactness steps: losses within
    1e-5 relative at step 1 and 1e-4 at steps 2-3, the gathered
    softmax_out.w within 1e-4 of its largest magnitude), then 5 timed
    steps with the launch counts reset just before and read just after,
    held per step to parts 2 / dx 1 / dw 1 (no B4), add-LN 60,
    matmul_bias_act 48; every replicated persistable bit-equal across the
    ranks after step 3 and after the last; and the narrow config of the
    CPU tests 3 steps on the card's two ranks against the CPU's (1e-5
    relative).  With `profile_dir`, rank 0 profiles 3 more steps
    (chiprun_out/profile_training_vocab_parallel.json).  Returns rank 0's
    launches over the timed steps."""
    import multiprocessing
    import pickle
    import tempfile

    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tfm

    hp = tfm.ModelHyperParams
    main, startup, fetch = _vp_program(hp, None, TRAIN_LEN)
    per_step = _expected_train_launches(main)
    for kind in ("fwd", "dx", "dw"):  # the projection moves to B12's kernels
        sharded = "linear_xent_parts" if kind == "fwd" else (
            "linear_xent_%s_sharded" % kind)
        per_step[sharded] = per_step.pop("linear_xent_" + kind)
        per_step["linear_xent_" + kind] = 0
    assert {k: per_step[k] for k in (
        "linear_xent_parts", "linear_xent_dx_sharded",
        "linear_xent_dw_sharded", "linear_xent_fwd", "fused_add_layer_norm",
        "matmul_bias_act")} == {
            "linear_xent_parts": 2, "linear_xent_dx_sharded": 1,
            "linear_xent_dw_sharded": 1, "linear_xent_fwd": 0,
            "fused_add_layer_norm": 60, "matmul_bias_act": 48}, per_step
    batch = tfm.make_fake_batch(TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN, hp, seed=0)
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CUDAPlace(0))
        exe.run(startup)
        base = [float(exe.run(main, feed=batch, fetch_list=[fetch[0]])[0].sum())
                for _ in range(VP_WARMUP + 1)]
        w_base = scope.find_var(_vocab_slab_names(
            scope.local_var_names())[0]).cpu().numpy()
    del scope, exe
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        procs = [ctx.Process(target=_vp_rank,
                             args=(r, os.path.join(d, "store"), d,
                                   profile_dir))
                 for r in range(VP_MP)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        assert not hung, "a vocab-parallel rank hung"
        res = []
        for r in range(VP_MP):
            path = os.path.join(d, "rank%d.pkl" % r)
            assert os.path.exists(path), ("rank %d left no result, exit %s"
                                          % (r, procs[r].exitcode))
            with open(path, "rb") as f:
                res.append(pickle.load(f))
            assert "error" not in res[r], "rank %d failed:\n%s" % (
                r, res[r]["error"])
        assert [p.exitcode for p in procs] == [0] * VP_MP, [
            p.exitcode for p in procs]
        w_vp = np.load(os.path.join(d, "w_gathered.npy"))
        ranks_s = time.time() - t0
    r0 = res[0]
    exact = r0["losses"][:VP_WARMUP + 1]
    rel = [abs(a - b) / abs(b) for a, b in zip(exact, base)]
    assert rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4, (exact, base, rel)
    w_err = float(np.abs(w_vp - w_base).max() / np.abs(w_base).max())
    assert w_vp.shape == w_base.shape == (HP_D_MODEL, HP_VOCAB) and (
        w_err <= 1e-4), (w_vp.shape, w_err)
    for r in range(1, VP_MP):
        assert res[r]["losses"] == r0["losses"], "ranks disagree on the loss"
        for key in ("sums_exact", "sums_last"):
            differ = [n for n, v in r0[key].items() if res[r][key][n] != v]
            assert not differ, ("replicated state differs across ranks", key,
                                differ[:5])
    for out in res:
        assert all(shape == (HP_D_MODEL, HP_VOCAB // VP_MP)
                   for shape in out["held"].values()), out["held"]
        assert len(out["held"]) == 3, out["held"]
        assert np.isfinite(out["losses"]).all()
        np.testing.assert_allclose(out["narrow"]["cuda"], out["narrow"]["cpu"],
                                   rtol=1e-5)
    for name, n in per_step.items():
        assert r0["launches"][name] == n * VP_STEPS, (
            "launch count", name, r0["launches"][name], n)
    times = r0["times"]
    p50 = sorted(times)[len(times) // 2]
    n_tok = float(batch["lbl_weight"].sum())
    print("trained Transformer-base vocab-parallel (mp %d, batch %d x %d; %s; "
          "%d ranks time-slice ONE card over gloo, so this is no multi-card "
          "step time) %d timed steps after %d warm-up: step p50 %.3f ms, mean "
          "%.3f ms, %.1f target tokens/s (%d a step); peak memory per rank "
          "%s GB; losses %s vs the unsharded run's %s (relative differences "
          "%s), gathered softmax_out.w within %.3g of its largest magnitude "
          "after step %d; replicated state bit-equal across the ranks; launches "
          "per step per rank %s; narrow config on the card's ranks %s vs the "
          "CPU's %s; ranks' wall %.1f s" % (
              VP_MP, TRAIN_BATCH, TRAIN_LEN, smi, VP_MP, VP_STEPS, VP_WARMUP,
              p50 * 1e3, sum(times) / len(times) * 1e3, n_tok / p50, n_tok,
              [round(o["peak"] / 1e9, 3) for o in res],
              json.dumps([round(v, 6) for v in r0["losses"]]),
              json.dumps([round(v, 6) for v in base]),
              ["%.3g" % v for v in rel], w_err, VP_WARMUP + 1,
              json.dumps({k: v // VP_STEPS for k, v in r0["launches"].items()
                          if v}),
              r0["narrow"]["cuda"], r0["narrow"]["cpu"], ranks_s))
    return r0["launches"]


def bert_base_config():
    """BERT-base (BertConfig's defaults: google-research/bert
    uncased_L-12_H-768_A-12, vocab 30522, hidden 768, 12 layers, 12
    heads, intermediate 3072, 512 positions, dropout 0.1) with its
    attention on the flash kernels (fused_attn)."""
    from paddle_tpu_torch.models import bert

    class BertBase(bert.BertConfig):
        fused_attn = True

    return BertBase


def train_bert_base(dev, profile_dir=None):
    """The BERT pretraining path: bert_pretrain_program(bert_base_config(),
    seq_len=128, lr=1e-4) — MLM over every position, NSP on [CLS], Adam —
    on make_fake_bert_batch(32, 128, seed=0) (ragged lengths in [64, 128],
    so the key bias masks pads), random weights from a seed, through
    _train_on_card.  The first loss must be near ln 30522 + ln 2 = 11.02
    (random weights at std 0.02 give near-uniform logits)."""
    import math

    from paddle_tpu_torch.models import bert

    hp = bert_base_config()
    main, startup, _, fetch = bert.bert_pretrain_program(hp, seq_len=BERT_LEN,
                                                         lr=1e-4)
    startup.random_seed = main.random_seed = 2026
    per_step = _expected_train_launches(main)
    assert per_step == {"matmul_bias_act": 54, "fused_add_layer_norm": 48,
                        "linear_xent_fwd": 2, "linear_xent_dx": 1,
                        "linear_xent_dw": 1, "flash_attention_qvec": 0,
                        "fused_layer_norm": 4, "flash_attention_fwd": 24,
                        "flash_attention_dq": 12,
                        "flash_attention_dkv": 12,
                        "matmul_swiglu": 0, "softmax_xent_fwd": 2,
                        "softmax_xent_bwd": 1, "fused_lstm": 0,
                        "fused_gru": 0}, per_step
    batch = bert.make_fake_bert_batch(BERT_BATCH, BERT_LEN, hp, seed=0)
    ln = math.log(hp.vocab_size) + math.log(2)
    return _train_on_card(
        "BERT-base (batch %d x %d)" % (BERT_BATCH, BERT_LEN), main, startup,
        fetch, batch, BERT_ROWS, BERT_ROWS, (ln - 0.5, ln + 0.5), per_step,
        profile_dir, "training_bert", loss_parts=("mlm", "nsp"))


def bert_train_card_matches_cpu(dev):
    """A narrow BERT (vocab 1000, d_model 256, 4 heads of 64, 2 layers,
    seq 128, dropout 0, fused_attn, ragged lengths): every kernel of the
    BERT training path, the softmax cross-entropy kernels included; the
    total, MLM and NSP losses agree."""
    from paddle_tpu_torch.models import bert

    class Narrow(bert.BertConfig):
        vocab_size, max_position, d_model, d_inner_hid = 1000, 128, 256, 1024
        n_head, n_layer, dropout, fused_attn = 4, 2, 0.0, True

    main, startup, _, fetch = bert.bert_pretrain_program(Narrow, seq_len=128)
    startup.random_seed = 13
    _card_matches_cpu("BERT", main, startup, fetch,
                      bert.make_fake_bert_batch(8, 128, Narrow, seed=3),
                      GPT2_KERNELS + ("matmul_bias_act",
                                      "fused_add_layer_norm",
                                      "linear_xent_fwd", "linear_xent_dx",
                                      "linear_xent_dw", "softmax_xent_fwd",
                                      "softmax_xent_bwd"))


def gpt2_train_card_matches_cpu(dev):
    """A narrow GPT-2 (vocab 1000, d_model 256, 4 heads of 64, 2 layers,
    seq 128, dropout 0): every kernel of the GPT-2 training path."""
    from paddle_tpu_torch.models import gpt2

    class Narrow(gpt2.GPT2Config):
        vocab_size, n_ctx, d_model, n_layer, n_head = 1000, 128, 256, 2, 4
        dropout = 0.0

    main, startup, _, fetch = gpt2.gpt2_lm_program(Narrow, seq_len=128)
    startup.random_seed = 9
    _card_matches_cpu("GPT-2", main, startup, fetch,
                      gpt2.make_fake_lm_batch(4, 128, Narrow, seed=3),
                      GPT2_KERNELS + ("matmul_bias_act",
                                      "fused_add_layer_norm",
                                      "linear_xent_fwd", "linear_xent_dx",
                                      "linear_xent_dw"))


def llama_train_card_matches_cpu(dev):
    """The narrow modern-decoder config (narrow_modern_config, seq 128):
    every kernel of the TinyLlama-width training path, matmul_swiglu
    included; RoPE's angles reach 127 rad, where the card's and the
    CPU's float32 sin/cos may differ in the last bits."""
    from paddle_tpu_torch.models import gpt2

    hp = narrow_modern_config()
    main, startup, _, fetch = gpt2.gpt2_lm_program(hp, seq_len=128)
    startup.random_seed = 11
    _card_matches_cpu("modern config", main, startup, fetch,
                      gpt2.make_fake_lm_batch(4, 128, hp, seed=3),
                      GPT2_KERNELS + ("matmul_swiglu", "matmul_bias_act",
                                      "fused_add_layer_norm",
                                      "linear_xent_fwd", "linear_xent_dx",
                                      "linear_xent_dw"))


def _decode_launches(main):
    """Kernel launches of one run of a decode program, read off its ops:
    fc on matmul_bias_act, fused_swiglu on matmul_swiglu,
    fused_residual_ln on add-LN, every layer_norm (the kernel form in
    these programs) on layer norm, fused_attention on the B3 forward
    (key bias or causal), on B9's forward (one QStart for a batch of
    several rows) or on the qvec forward (a QStart per row), and a
    forward padded_gru or padded_lstm on its recurrent kernel.  A program
    without these ops (the cache startup, the beam reorder) launches
    nothing."""
    from paddle_tpu_torch import kernels

    block = main.global_block()
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    by_type = {"fc": "matmul_bias_act", "fused_swiglu": "matmul_swiglu",
               "fused_residual_ln": "fused_add_layer_norm",
               "layer_norm": "fused_layer_norm"}
    for op in block.ops:
        if op.type in by_type:
            want[by_type[op.type]] += 1
        elif op.type in ("padded_lstm", "padded_gru"):
            if not op.attrs.get("is_reverse", False):
                want["fused_" + op.type[len("padded_"):]] += 1
        elif op.type == "fused_attention":
            qs = op.inputs.get("QStart")
            if not qs:
                want["flash_attention_fwd"] += 1
            elif (block.var(qs[0]).shape[0] == 1
                  and block.var(op.inputs["Q"][0]).shape[0] > 1):
                want["flash_attention_piece_fwd"] += 1
            else:
                want["flash_attention_qvec"] += 1
    return want


class _DecodeRuns:
    """An executor's run, wrapped for a decode phase: every run starts
    with every launch count at 0 and ends with the counts held to what
    its program implies; keeps each program's host times (each run ends
    with the fetch copied to the host), the slices of its fetches that
    `keep[id(program)](fetch, k)` picks for its k-th run, the number of
    runs by feed names, and the phase's launch totals."""

    def __init__(self, exe):
        import collections

        import torch

        from paddle_tpu_torch import kernels

        self.totals = {fn.__name__: 0 for fn in kernels.KERNELS}
        self.times, self.kept, self.keep = {}, {}, {}
        self.feeds = collections.Counter()
        want_by_program = {}
        run = exe.run

        def checked_run(program=None, feed=None, fetch_list=None, **kw):
            key = id(program)
            if key not in want_by_program:
                want_by_program[key] = (program, _decode_launches(program))
            want = want_by_program[key][1]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = run(program, feed=feed, fetch_list=fetch_list, **kw)
            torch.cuda.synchronize()
            self.times.setdefault(key, []).append(time.perf_counter() - t0)
            got = {fn.__name__: fn.launches for fn in kernels.KERNELS}
            assert got == want, ("launches of a decode run", got, want)
            for name, n in got.items():
                self.totals[name] += n
            self.feeds[tuple(sorted(feed or ()))] += 1
            if key in self.keep:
                kept = self.kept.setdefault(key, [])
                kept.append(self.keep[key](out[0], len(kept)))
            return out

        exe.run = checked_run


def _p50_ms(times):
    return sorted(times)[len(times) // 2] * 1e3


def _rel_err(got, want):
    import numpy as np

    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _last_chunk_start(p, width, t_max):
    """Where run_chunked_ids starts its last chunk of a p-token prompt."""
    last = ((p - 1) // width) * width
    return max(0, t_max - width) if last + width > t_max else last


def _decode_on_card(label, hp, t_max, batch, prompt_len, width, new, seed,
                    beam_and_sample, profile_dir, profile_name):
    """One KV-cached decode path on the card: `hp` with random weights
    from `seed`, gpt2_decode_step_program at batch `batch` (one token)
    and at width `width` (the chunked prefill), t_max `t_max`, over
    seeded prompts of `prompt_len` tokens.  Checks: chunked prefill's
    last-position logits within 1e-4 of one-token prefill's (relative to
    their largest magnitude) over the prompts' first `width` +
    PREFILL_CHECK_EXTRA tokens (a full chunk, then a ragged one);
    greedy_generate_cached (`new` tokens, chunked prefill) equal to
    greedy_generate on gpt2_logits_program (seq_len prompt + `new`)
    token for token over the first GREEDY_CHECK_NEW new tokens wherever
    the top-2 logit margin exceeds 1e-3, the logits compared step by
    step (1e-4 relative); with
    `beam_and_sample`, seeded sample_generate_cached (top-k 40, top-p
    0.9) and beam_generate_cached (beam 4 over 2 prompts, step and wide
    programs at batch 8, the reorder program every step) finish with
    finite logits and scores.  Every run's launches are held to its
    program's.  Prints the one-token step's p50 and decode tokens/s,
    the chunked prefill's tokens/s and the beam step's p50; with a
    profile dir, a torch.profiler window of 8 one-token steps.  Returns
    the phase's launch totals."""
    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import gpt2

    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CUDAPlace(0))
        total = prompt_len + new
        logits_main, start, _, logits_fetch = gpt2.gpt2_logits_program(
            hp, seq_len=total)
        start.random_seed = seed
        exe.run(start)
        step, cache_start, _, fetch, _ = gpt2.gpt2_decode_step_program(
            hp, batch=batch, t_max=t_max)
        wide, _, _, wide_fetch, _ = gpt2.gpt2_decode_step_program(
            hp, batch=batch, t_max=t_max, width=width)
        prefill = (wide, wide_fetch, width, t_max)
        runs = _DecodeRuns(exe)
        prompts = np.random.RandomState(seed).randint(
            1, hp.vocab_size, (batch, prompt_len)).astype("int64")

        # chunked prefill against one-token prefill: a chunk and a ragged
        # one carry the cache from chunk to chunk as the whole prompt does
        head = prompts[:, :width + PREFILL_CHECK_EXTRA]
        exe.run(cache_start)
        one = gpt2._prefill_cached(exe, step, fetch, head)
        exe.run(cache_start)
        chunked = gpt2.prefill_cached_chunked(exe, wide, wide_fetch, head,
                                              width, t_max)
        assert chunked.shape == one.shape == (batch, hp.vocab_size)
        prefill_err = _rel_err(chunked, one)
        assert prefill_err <= 1e-4, ("chunked != one-token prefill", label,
                                     prefill_err)

        # cached greedy against uncached greedy, step by step: the
        # prefill's logits at the prompt's last position, then each step's
        last_c0 = _last_chunk_start(prompt_len, width, t_max)
        runs.keep[id(step)] = lambda lg, k: lg
        runs.keep[id(wide)] = lambda lg, k: lg[:, prompt_len - 1 - last_c0]
        n_wide = len(runs.times[id(wide)])
        cached = gpt2.greedy_generate_cached(exe, step, cache_start, fetch,
                                             prompts, new, prefill=prefill)
        cached_logits = ([runs.kept[id(wide)][-1]]
                         + runs.kept[id(step)][-(new - 1):])
        step_times = runs.times[id(step)][-(new - 1):]
        step_p50 = _p50_ms(step_times)
        n_chunks = len(runs.times[id(wide)]) - n_wide
        assert n_chunks == -(-prompt_len // width)
        prefill_s = sum(runs.times[id(wide)][-n_chunks:])
        runs.keep[id(logits_main)] = (
            lambda lg, k: np.array(lg[:, prompt_len - 1 + k]))
        uncached = gpt2.greedy_generate(exe, logits_main, logits_fetch,
                                        prompts, GREEDY_CHECK_NEW)
        assert cached.shape == (batch, total)
        assert uncached.shape == (batch, prompt_len + GREEDY_CHECK_NEW)
        np.testing.assert_array_equal(cached[:, :prompt_len], prompts)
        logit_err, compared, near_ties = 0.0, 0, 0
        for i, (a, b) in enumerate(zip(cached_logits,
                                       runs.kept[id(logits_main)])):
            assert np.isfinite(a).all()
            logit_err = max(logit_err, _rel_err(a, b))
            assert logit_err <= 1e-4, ("cached != uncached logits", label, i,
                                       logit_err)
            compared += 1
            top2 = np.sort(b, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 1e-3
            tok_c, tok_u = cached[:, prompt_len + i], uncached[:, prompt_len + i]
            assert (tok_c == tok_u)[clear].all(), ("cached != uncached tokens",
                                                   label, i)
            if not (tok_c == tok_u).all():
                near_ties += 1
                break  # a near tie decided differently: the rows diverge
        assert compared == GREEDY_CHECK_NEW or near_ties, compared
        print("%s decode: batch %d, prompt %d, chunked prefill (width %d) "
              "within %.3g of one-token prefill over %d tokens; the whole "
              "prompt's %d chunks in %.1f ms (%.1f tokens/s); cached greedy "
              "== uncached over %d steps (max logit difference %.3g "
              "relative, %d near-tie stops); one-token step p50 %.3f ms "
              "(mean %.3f), %.1f decode tokens/s" % (
                  label, batch, prompt_len, width, prefill_err,
                  head.shape[1], n_chunks, prefill_s * 1e3,
                  batch * prompt_len / prefill_s, compared,
                  logit_err, near_ties, step_p50,
                  1e3 * sum(step_times) / len(step_times),
                  batch * 1e3 / step_p50))

        if beam_and_sample:
            sampled = gpt2.sample_generate_cached(
                exe, step, cache_start, fetch, prompts, SAMPLE_NEW,
                top_k=40, top_p=0.9, seed=0, prefill=prefill)
            assert sampled.shape == (batch, prompt_len + SAMPLE_NEW)
            assert ((sampled >= 0) & (sampled < hp.vocab_size)).all()
            assert all(np.isfinite(lg).all()
                       for lg in runs.kept[id(step)][-(SAMPLE_NEW - 1):])
            rows = BEAM_PROMPTS * BEAM_SIZE
            bstep, bstart, _, bfetch, _ = gpt2.gpt2_decode_step_program(
                hp, batch=rows, t_max=t_max)
            bwide, _, _, bwide_fetch, _ = gpt2.gpt2_decode_step_program(
                hp, batch=rows, t_max=t_max, width=width)
            reorders = runs.feeds[("parents",)]
            ids, scores = gpt2.beam_generate_cached(
                exe, bstep, bstart, bfetch, prompts[:BEAM_PROMPTS], BEAM_NEW,
                beam_size=BEAM_SIZE,
                prefill=(bwide, bwide_fetch, width, t_max))
            assert ids.shape == (BEAM_PROMPTS, prompt_len + BEAM_NEW)
            assert np.isfinite(scores).all(), scores
            n_steps = len(runs.times[id(bstep)])
            assert n_steps == BEAM_NEW - 1
            assert runs.feeds[("parents",)] - reorders == n_steps
            print("%s decode: seeded sample (top-k 40, top-p 0.9) %d tokens; "
                  "beam %d over %d prompts: %d steps, each after a cache "
                  "reorder, step p50 %.3f ms, scores %s" % (
                      label, SAMPLE_NEW, BEAM_SIZE, BEAM_PROMPTS, n_steps,
                      _p50_ms(runs.times[id(bstep)]), scores.tolist()))

        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            tok = cached[:, -1:]
            exe.run(cache_start)  # the beam's batch-8 caches share names
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(8):
                    exe.run(step, feed={"step_ids": tok, "pos": np.array(
                        [min(total - 1 + i, t_max - 1)], "int64")},
                            fetch_list=fetch)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            _profile_report(prof, wall_us, 8, profile_name, profile_dir)
    return runs.totals


def decode_gpt2_small(dev, profile_dir=None):
    """KV-cached decoding of GPT-2 small at full width: batch 4, t_max
    1024, 4 seeded prompts of 200 tokens, chunked prefill 64 wide, 56 new
    tokens greedy, then seeded sampling and beam 4 over 2 prompts."""
    from paddle_tpu_torch.models import gpt2

    return _decode_on_card("GPT-2 small", gpt2.GPT2Config, T_MAX,
                           DECODE_BATCH, DECODE_PROMPT, DECODE_WIDTH,
                           DECODE_NEW, 1236, True, profile_dir, "decode")


def decode_tinyllama(dev, profile_dir=None):
    """KV-cached greedy decoding at TinyLlama-1.1B's widths: batch 2,
    t_max 2048, prompts of 256 tokens, chunked prefill 128 wide, 32 new
    tokens; the one path through the GQA fold (B3 at Tq 8 with a key
    bias) and rotary on pos / pos_vec."""
    return _decode_on_card("TinyLlama-1.1B widths", tinyllama_config(),
                           LLAMA_LEN, LLAMA_DECODE_BATCH, LLAMA_DECODE_PROMPT,
                           LLAMA_DECODE_WIDTH, LLAMA_DECODE_NEW, 1237, False,
                           profile_dir, "decode_llama")


def decode_card_matches_cpu(dev, Narrow, must_launch):
    """The narrow config `Narrow` decoded on the card and on the CPU plain
    path from the same weights: greedy (chunked prefill 8 wide), seeded
    sample (top-k 8, top-p 0.9, temperature 0.8) and beam 3, two prompts
    of 11 tokens, t_max 48.  Tokens and beam ids equal, beam scores and
    every run's logits within 1e-5 relative; the card's runs launched
    each kernel of `must_launch`."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import gpt2

    t_max, width = 48, 8
    prompts = np.random.RandomState(4).randint(
        1, Narrow.vocab_size, (2, 11)).astype("int64")
    results, logits = {}, {}
    launched = {fn.__name__: 0 for fn in kernels.KERNELS}
    for kind in ("cpu", "cuda"):
        scope = ptt.Scope()
        with ptt.scope_guard(scope):
            place = ptt.CPUPlace() if kind == "cpu" else ptt.CUDAPlace(0)
            exe = ptt.Executor(place)
            _, startup, _, _ = gpt2.gpt2_logits_program(Narrow, seq_len=t_max)
            if kind == "cpu":
                startup.random_seed = 6
                exe.run(startup)
                weights = {n: scope.find_var(n).clone()
                           for n in scope.local_var_names()}
            else:
                for n, w in weights.items():
                    scope.set(n, w.to(dev))
            progs = {}
            for rows in (2, 6):
                step, start, _, fetch, _ = gpt2.gpt2_decode_step_program(
                    Narrow, batch=rows, t_max=t_max)
                wide, _, _, wide_fetch, _ = gpt2.gpt2_decode_step_program(
                    Narrow, batch=rows, t_max=t_max, width=width)
                progs[rows] = (step, start, fetch,
                               (wide, wide_fetch, width, t_max))
            seen = logits[kind] = []
            run = exe.run

            def recording(program=None, feed=None, fetch_list=None, **kw):
                kernels.reset_launch_counts()
                out = run(program, feed=feed, fetch_list=fetch_list, **kw)
                if kind == "cuda":
                    for fn in kernels.KERNELS:
                        launched[fn.__name__] += fn.launches
                if fetch_list:
                    seen.append(out[0])
                return out

            exe.run = recording
            step, start, fetch, prefill = progs[2]
            greedy = gpt2.greedy_generate_cached(exe, step, start, fetch,
                                                 prompts, 10, prefill=prefill)
            sample = gpt2.sample_generate_cached(
                exe, step, start, fetch, prompts, 10, temperature=0.8,
                top_k=8, top_p=0.9, seed=1, prefill=prefill)
            step, start, fetch, prefill = progs[6]
            beam = gpt2.beam_generate_cached(exe, step, start, fetch, prompts,
                                             8, beam_size=3, prefill=prefill)
            results[kind] = (greedy, sample, beam)
    cpu, card = results["cpu"], results["cuda"]
    for a, b in zip(cpu[:2] + cpu[2][:1], card[:2] + card[2][:1]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(card[2][1], cpu[2][1], rtol=1e-5)
    assert len(logits["cpu"]) == len(logits["cuda"]) > 0
    err = max(_rel_err(b, a) for a, b in zip(logits["cpu"], logits["cuda"]))
    assert err <= 1e-5, ("card != CPU decode logits", Narrow.__name__, err)
    assert all(launched[n] for n in must_launch), (
        "a kernel did not launch", launched)
    print("%s decoded on the card vs the CPU plain path (greedy, sample, "
          "beam): tokens equal, %d runs' logits within %.3g relative; "
          "launches %s" % (Narrow.__name__, len(logits["cpu"]), err,
                           json.dumps(launched)))


def check_recurrent(dev, randn, g):
    """fused_lstm (B11) and fused_gru (B10) against their plain versions
    on the card at every shape the recurrent paths give them: the LSTM
    path's xproj [32, 64, 4 x 512], the seq2seq training GRUs' [32, 50,
    3 x 512], the decode step's encoder [8, 50, 3 x 512] and its one GRU
    step [8, 1, 3 x 512] from a nonzero h0, and the narrow legs' H 16;
    with ragged lengths (0, 1 and T among them) and full ones; plus H 200
    and 700 (700 over 132 SMs leaves the last block 4 of its 6 units)
    and 200 rows at H 512 (more rows than one staged tile).  Limit 1e-5
    absolute on hs and cs (2e-6 measured on the H100 at the paths'
    shapes: the kernel's fixed-order dot and the plain version's matmul
    differ in summation order over up to 64 steps); every rerun is
    bit-equal.  Timed with CUDA events (a cooperative launch, so no
    graph capture) at the paths' full-length shapes, beside the plain
    version and, for the LSTM, torch.nn.LSTM (cuDNN)."""
    import torch

    from paddle_tpu_torch.kernels import (fused_gru, fused_lstm,
                                          gru_seq_plain, lstm_seq_plain)

    def inputs(b, t, h, gates, ragged):
        if ragged:
            lens = torch.randint(0, t + 1, (b,), generator=g, device=dev)
            lens[0], lens[-1] = 0, t
            lens[1 % b] = min(1, t)
        else:
            lens = torch.full((b,), t, device=dev, dtype=torch.long)
        return (randn(b, t, gates * h), randn(h, gates * h, scale=h ** -0.5),
                randn(b, h), randn(b, h), lens)

    def run(kind, x, w, h0, c0, lens, plain=False):
        if kind == "lstm":
            fn = lstm_seq_plain if plain else fused_lstm
            return fn(x, w, h0, c0, lens)
        return ((gru_seq_plain if plain else fused_gru)(x, w, h0, lens),)

    rows = S2S_BEAM * S2S_BEAM_SENTS
    shapes = [("lstm", LSTM_BATCH, LSTM_LEN, LSTM_H),
              ("lstm", 4, 12, 16), ("lstm", 5, 7, 200), ("lstm", 6, 9, 700),
              ("lstm", 200, 5, LSTM_H),
              ("gru", S2S_BATCH, S2S_LEN, S2S_H),
              ("gru", rows, S2S_LEN, S2S_H),
              ("gru", rows, 1, S2S_H), ("gru", 4, 8, 16), ("gru", 5, 7, 200),
              ("gru", 6, 9, 700), ("gru", 200, 5, S2S_H)]
    err = {"lstm": 0.0, "gru": 0.0}
    for kind, b, t, h in shapes:
        for ragged in (True, False):
            args = inputs(b, t, h, 4 if kind == "lstm" else 3, ragged)
            got = run(kind, *args)
            again = run(kind, *args)
            assert all(torch.equal(a, c) for a, c in zip(got, again)), (
                "rerun not bit-equal", kind, b, t, h)
            want = run(kind, *args, plain=True)
            err[kind] = max(err[kind], max((a - c).abs().max().item()
                                           for a, c in zip(got, want)))
    assert max(err.values()) <= 1e-5, ("recurrent kernels disagree", err)

    def times(kind, b, t, h):
        gates = 4 if kind == "lstm" else 3
        x, w, h0, c0, lens = inputs(b, t, h, gates, False)
        states = 2 if kind == "lstm" else 1
        # the work this run's lengths need: each valid step's product
        # h [b, H] @ W [H, gates H]; bytes: xproj, W, the initial states
        # and the lengths read once, hs (and cs) written once
        steps = int(lens.sum())
        b_ms, by = _bound_ms(4 * (b * t * gates * h + h * gates * h
                                  + states * b * h + b + states * b * t * h),
                             2 * steps * h * gates * h)
        rec = dict(ms=_events_ms(lambda: run(kind, x, w, h0, c0, lens), 10),
                   plain_ms=_events_ms(
                       lambda: run(kind, x, w, h0, c0, lens, plain=True), 3),
                   bound_ms=b_ms, bound_by=by, library_ms=None)
        if kind == "lstm":
            cudnn = torch.nn.LSTM(h, h, batch_first=True).to(dev)
            xin = randn(b, t, h)
            with torch.no_grad():
                rec["library_ms"] = _events_ms(
                    lambda: cudnn(xin, (h0[None], c0[None])), 10)
        return rec

    lstm = times("lstm", LSTM_BATCH, LSTM_LEN, LSTM_H)
    gru = times("gru", S2S_BATCH, S2S_LEN, S2S_H)
    gru_shapes = {
        "decode encoder xproj [%d, %d, %d]" % (rows, S2S_LEN, 3 * S2S_H):
        times("gru", rows, S2S_LEN, S2S_H),
        "decode step xproj [%d, 1, %d], nonzero h0" % (rows, 3 * S2S_H):
        times("gru", rows, 1, S2S_H)}
    torch.cuda.synchronize()
    return {
        "fused_lstm": dict(
            route="cuda", source="paddle_tpu_torch/kernels/csrc/recurrent.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py:948",
            shape="xproj [%d, %d, %d], W [%d, %d], full lengths" % (
                LSTM_BATCH, LSTM_LEN, 4 * LSTM_H, LSTM_H, 4 * LSTM_H),
            max_abs_err=err["lstm"],
            library_note="torch.nn.LSTM (cuDNN, gate order i|f|g|o, hidden "
                         "and input 512) also computes the input product "
                         "x W_ih that the kernel is handed as xproj",
            **lstm),
        "fused_gru": dict(
            route="cuda", source="paddle_tpu_torch/kernels/csrc/recurrent.cu",
            replaces="paddle_tpu/ops/pallas_kernels.py:834",
            shape="xproj [%d, %d, %d], W [%d, %d], full lengths" % (
                S2S_BATCH, S2S_LEN, 3 * S2S_H, S2S_H, 3 * S2S_H),
            max_abs_err=err["gru"],
            library_note="none: no PyTorch call computes this GRU; cuDNN's "
                         "(torch.nn.GRU) applies the reset after the "
                         "recurrent product, r * (W_hn h + b_hn), where this "
                         "one forms (r h) W_c",
            per_shape=gru_shapes, **gru)}


def _rnn_program(build, *args, **kw):
    """A recurrent model's program under a fresh name generator, with
    Adam(1e-3) on its loss unless `adam=False`: (main, startup,
    builder's outputs)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer, unique_name

    adam = kw.pop("adam", True)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), unique_name.guard():
        out = build(*args, **kw)
        if adam:
            optimizer.Adam(1e-3).minimize(out[1])
    return main, startup, out


def _lstm_batch(batch, t, dict_size, seed, ragged=False):
    """Seeded words below dict_size, binary labels, and lengths: full, or
    ragged in [1, t]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lens = rng.randint(1, t + 1, batch) if ragged else np.full(batch, t)
    return {"words": rng.randint(0, dict_size, (batch, t)).astype("int64"),
            "seq_len": lens.astype("int64"),
            "label": rng.randint(0, 2, (batch, 1)).astype("int64")}


def _s2s_batch(batch, t, src_dict, tgt_dict, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"src_word_id": rng.randint(0, src_dict, (batch, t)),
            "target_language_word": rng.randint(0, tgt_dict, (batch, t)),
            "target_language_next_word": rng.randint(0, tgt_dict, (batch, t))}


def train_stacked_lstm(dev, profile_dir=None):
    """The stacked dynamic LSTM training path: build_stacked_lstm_train at
    bench.py's stacked_lstm setting (dict 10000, 64 tokens, emb and
    hidden 512, 3 layers, 2 classes, Adam 1e-3) on batch 32 x 64 of seeded
    words, full lengths, random weights from a seed, through
    _train_on_card.  Layers 1 and 3 run fused_lstm; layer 2 is reversed
    and runs the reference's plain scan.  The first loss must be near
    ln 2 (near-uniform class scores)."""
    import math

    from paddle_tpu_torch.models import stacked_dynamic_lstm as sdl

    main, startup, (_, loss, acc) = _rnn_program(
        sdl.build_stacked_lstm_train, LSTM_DICT, LSTM_LEN, emb_dim=LSTM_H,
        hidden_dim=LSTM_H, stacked_num=LSTM_STACK, class_dim=2)
    startup.random_seed = main.random_seed = 2027
    per_step = _expected_train_launches(main)
    assert per_step["fused_lstm"] == 4 and sum(per_step.values()) == 4, \
        per_step
    batch = _lstm_batch(LSTM_BATCH, LSTM_LEN, LSTM_DICT, seed=0)
    tokens = LSTM_BATCH * LSTM_LEN
    return _train_on_card(
        "stacked dynamic LSTM (batch %d x %d)" % (LSTM_BATCH, LSTM_LEN), main,
        startup, [loss, acc], batch, tokens, tokens,
        (math.log(2) - 0.1, math.log(2) + 0.1), per_step, profile_dir,
        "training_lstm", steps=RNN_STEPS, dropout=False,
        loss_parts=("accuracy",))


def train_seq2seq(dev, profile_dir=None):
    """The GRU seq2seq training path: build_seq2seq_train at Paddle's
    benchmark machine_translation widths (embedding and hidden 512,
    source and target dictionaries 30000, Adam 1e-3) on batch 32 of 50
    source and 50 target tokens, random weights from a seed, through
    _train_on_card.  Both GRUs (encoder, teacher-forced decoder) run
    fused_gru.  The first loss must be near ln 30000."""
    import math

    from paddle_tpu_torch.models import machine_translation as mt

    main, startup, (_, loss) = _rnn_program(
        mt.build_seq2seq_train, S2S_DICT, S2S_DICT, S2S_LEN, S2S_LEN,
        embed_dim=S2S_H, hidden_dim=S2S_H)
    startup.random_seed = main.random_seed = 2028
    per_step = _expected_train_launches(main)
    assert per_step["fused_gru"] == 4 and sum(per_step.values()) == 4, \
        per_step
    batch = _s2s_batch(S2S_BATCH, S2S_LEN, S2S_DICT, S2S_DICT, seed=0)
    tokens = S2S_BATCH * S2S_LEN
    ln_v = math.log(S2S_DICT)
    return _train_on_card(
        "GRU seq2seq (batch %d x %d)" % (S2S_BATCH, S2S_LEN), main, startup,
        [loss], batch, tokens, tokens, (ln_v - 0.5, ln_v + 0.5), per_step,
        profile_dir, "training_seq2seq", steps=RNN_STEPS, dropout=False,
        loss_parts=())


def lstm_train_card_matches_cpu(dev):
    """The narrow stacked LSTM of the CPU tests (vocab 61, emb and hidden
    16, 3 layers, 12 tokens, batch 4, ragged lengths)."""
    from paddle_tpu_torch.models import stacked_dynamic_lstm as sdl

    main, startup, (_, loss, acc) = _rnn_program(
        sdl.build_stacked_lstm_train, 61, 12, emb_dim=16, hidden_dim=16,
        stacked_num=3, class_dim=2)
    startup.random_seed = 15
    _card_matches_cpu("stacked LSTM", main, startup, [loss, acc],
                      _lstm_batch(4, 12, 61, seed=3, ragged=True),
                      ("fused_lstm",))


def seq2seq_train_card_matches_cpu(dev):
    """The narrow seq2seq of the CPU tests (vocabularies 61 and 53, widths
    16, 8 tokens, batch 4)."""
    from paddle_tpu_torch.models import machine_translation as mt

    main, startup, (_, loss) = _rnn_program(
        mt.build_seq2seq_train, 61, 53, 8, 8, embed_dim=16, hidden_dim=16)
    startup.random_seed = 17
    _card_matches_cpu("GRU seq2seq", main, startup, [loss],
                      _s2s_batch(4, 8, 61, 53, seed=3), ("fused_gru",))


def _beam_decode(exe, main, logp, new_h, src, beam, hidden, steps):
    """One BeamSearchDecoder run over a decode step program: (ids,
    scores, every step's log-probs)."""
    import numpy as np

    from paddle_tpu_torch.contrib.decoder import BeamSearchDecoder

    logps = []

    def step_fn(tokens, states):
        lp, nh = exe.run(main, feed={
            "src_word_id": src,
            "cur_token": np.asarray(tokens).reshape(-1, 1).astype("int64"),
            "prev_hidden": np.asarray(states, "float32")},
            fetch_list=[logp, new_h])
        logps.append(lp)
        return lp, nh

    dec = BeamSearchDecoder(step_fn, beam, start_token=1, end_token=0,
                            max_len=steps)
    ids, scores = dec.decode(len(src) // beam, init_states=np.zeros(
        (len(src), hidden), "float32"))
    return ids, scores, logps


def decode_seq2seq(dev):
    """The GRU beam decode path: build_decode_step at the seq2seq widths
    (dictionaries 30000, embedding and hidden 512, source 50 tokens),
    random weights from a seed, driven by BeamSearchDecoder: beam 4 over
    2 sentences, 16 steps.  Each step re-encodes the source (fused_gru at
    T 50) and takes one GRU step from the previous hidden state
    (fused_gru at T 1 with H0); every run's launches are held to its
    program's, every step's log-probs are finite with rows that
    normalize."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import machine_translation as mt

    main, startup, (_, logp, new_h) = _rnn_program(
        mt.build_decode_step, S2S_DICT, S2S_DICT, S2S_LEN, embed_dim=S2S_H,
        hidden_dim=S2S_H, adam=False)
    startup.random_seed = 2029
    rng = np.random.RandomState(5)
    src = np.repeat(rng.randint(2, S2S_DICT, (S2S_BEAM_SENTS, S2S_LEN)),
                    S2S_BEAM, axis=0).astype("int64")
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CUDAPlace(0))
        exe.run(startup)
        runs = _DecodeRuns(exe)
        t0 = time.perf_counter()
        ids, scores, logps = _beam_decode(exe, main, logp, new_h, src,
                                          S2S_BEAM, S2S_H, S2S_BEAM_STEPS)
        wall = time.perf_counter() - t0
    rows = S2S_BEAM * S2S_BEAM_SENTS
    for lp in logps:
        assert lp.shape == (rows, S2S_DICT) and np.isfinite(lp).all()
        mass = np.exp(lp.astype("float64")).sum(-1)
        assert np.abs(mass - 1).max() < 1e-3, mass
    assert ids.shape[:2] == (S2S_BEAM_SENTS, S2S_BEAM)
    assert np.isfinite(scores).all()
    launches = runs.totals
    assert launches["fused_gru"] == 2 * len(logps) > 0, launches
    p50 = _p50_ms(runs.times[id(main)])
    print("decoded GRU seq2seq (beam %d over %d sentences, source %d): %d "
          "steps in %.3f s, decode step p50 %.3f ms, %.1f hypothesis "
          "tokens/s; scores %s; launches %s" % (
              S2S_BEAM, S2S_BEAM_SENTS, S2S_LEN, len(logps), wall, p50,
              rows / p50 * 1e3, json.dumps(np.round(scores, 4).tolist()),
              json.dumps(launches)))
    return launches


def seq2seq_decode_card_matches_cpu(dev):
    """The narrow decode step of the CPU tests (vocabularies 61 and 53,
    widths 16, source 8), beam 4 over 2 sentences, 6 steps, on the card
    and on the CPU from the same weights: the same tokens, and every
    step's log-probs within 1e-5 of their largest magnitude."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import machine_translation as mt

    main, startup, (_, logp, new_h) = _rnn_program(
        mt.build_decode_step, 61, 53, 8, embed_dim=16, hidden_dim=16,
        adam=False)
    startup.random_seed = 19
    rng = np.random.RandomState(9)
    src = np.repeat(rng.randint(2, 61, (2, 8)), 4, axis=0).astype("int64")
    out = {}
    for kind in ("cpu", "cuda"):
        with ptt.scope_guard(ptt.Scope()):
            place = ptt.CPUPlace() if kind == "cpu" else ptt.CUDAPlace(0)
            exe = ptt.Executor(place)
            if kind == "cpu":
                exe.run(startup)
                weights = {n: ptt.global_scope().find_var(n).clone()
                           for n in ptt.global_scope().local_var_names()}
            else:
                for n, w in weights.items():
                    ptt.global_scope().set(n, w.to(place.torch_device()))
            kernels.reset_launch_counts()
            out[kind] = _beam_decode(exe, main, logp, new_h, src, 4, 16, 6)
    launched = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    assert launched["fused_gru"] == 2 * len(out["cuda"][2]) > 0, launched
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    err = max(_rel_err(a, b) for a, b in zip(out["cuda"][2], out["cpu"][2]))
    assert len(out["cuda"][2]) == len(out["cpu"][2]) and err <= 1e-5, err
    print("narrow GRU seq2seq beam-decoded on the card vs the CPU plain "
          "path: tokens equal over %d steps, log-probs within %.3g of their "
          "largest magnitude; launches %s" % (len(out["cpu"][2]), err,
                                               json.dumps(launched)))


def train_packed_lm(dev, window=0, profile_dir=None):
    """The packed causal-LM path: examples/packed_training_torch.py's
    build(8, vocab=50257, seq_len=1024, d_model=768, heads=12, window)
    (GPT-2 small's published vocab, width, heads and context; the
    example's one attention block, causal over the packed segment ids,
    with a sliding window if `window`; Adam 3e-3), fed the first 8 rows
    of packed_batch, random weights from a seed, f32, through
    _train_on_card: one warm-up step (its masked loss near ln 50257),
    PACKED_STEPS timed steps with the launch counts held to the
    program's (flash forward 2, dq 1, dk/dv 1 a step: the example's
    layers.fc emits mul + elementwise_add and it runs no fuse pass, so
    its products are plain matmuls, as the reference's are XLA dots, and
    matmul_bias_act launches on this path none), and the bit-equal
    repeat.  Tokens/s counts the non-pad targets (seg_for_loss > 0)."""
    import math

    feed, seg = packed_batch(PACKED_ROWS, GPT2_LEN, GPT2_VOCAB, PACKED_SEQS)
    main, startup, loss = _example("packed_training_torch").build(
        PACKED_ROWS, vocab=GPT2_VOCAB, seq_len=GPT2_LEN, d_model=GPT2_D,
        heads=GPT2_HEADS, window=window)
    startup.random_seed = main.random_seed = 2026
    per_step = _expected_train_launches(main)
    want = dict.fromkeys(per_step, 0)
    want.update(flash_attention_fwd=2, flash_attention_dq=1,
                flash_attention_dkv=1)
    assert per_step == want, per_step
    n_tok = float((feed["seg"] > 0).sum())
    print("packed %d sequences (lengths log-uniform in [8, %d]) into rows "
          "of %d, the first %d kept: segments per row %s, fill %.4f, %d "
          "target tokens" % (PACKED_SEQS, GPT2_LEN, GPT2_LEN, PACKED_ROWS,
                             [len(set(r[r > 0].tolist())) for r in seg],
                             float((seg > 0).mean()), n_tok))
    ln_v = math.log(GPT2_VOCAB)
    return _train_on_card(
        "packed LM at GPT-2 small's widths (batch %d x %d%s)" % (
            PACKED_ROWS, GPT2_LEN, ", window %d" % window if window else ""),
        main, startup, [loss], feed, n_tok, PACKED_ROWS * GPT2_LEN,
        (ln_v - 0.5, ln_v + 0.5), per_step, profile_dir,
        "training_packed" + ("_window" if window else ""),
        steps=PACKED_STEPS, dropout=False, loss_parts=())


def packed_train_card_matches_cpu(dev):
    """The packed LM narrowed (vocab 1000, rows of 128, d_model 256, 4
    heads of 64, 6 rows of packed_batch) at window 0 and 48, 3 Adam
    steps on the card and on the CPU plain path from the same weights:
    losses within 1e-5 relative, every flash kernel launched."""
    for window in (0, 48):
        feed, _ = packed_batch(6, 128, 1000, 24, seed=1)
        main, startup, loss = _example("packed_training_torch").build(
            6, vocab=1000, seq_len=128, d_model=256, heads=4, window=window)
        startup.random_seed = 11
        _card_matches_cpu("packed LM (window %d)" % window, main, startup,
                          [loss], feed, GPT2_KERNELS[1:])


DECODE_KERNELS = ("flash_attention_fwd", "flash_attention_piece_fwd",
                  "matmul_bias_act", "fused_add_layer_norm")
# held on the card by the kernel phase only: no path of the repo trains
# through chunked attention or the ragged step yet (ring attention is
# ROADMAP A7; the reference's draft training and prefix tuning are not
# ported)
OFF_PATH_KERNELS = ("flash_attention_piece_dq", "flash_attention_piece_dkv",
                    "flash_attention_qvec_dq", "flash_attention_qvec_dkv")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch", "kernels")):
        print("chip_smoke: run from a checkout of the repository (no "
              "paddle_tpu_torch package beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))
    from paddle_tpu_torch.kernels import build

    print("nvcc: %s" % _sh([build.nvcc_path(), "--version"]).splitlines()[-1])
    t0 = time.time()
    build.load()
    print("kernels built in %.1f s from %s" % (time.time() - t0, build.CSRC))
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    laps = [time.time()]

    def lap(phase):
        """Prints the wall seconds since the last phase ended."""
        laps.append(time.time())
        print("phase %s: %.1f s" % (phase, laps[-1] - laps[-2]))

    rec = check_kernels(dev)
    lap("kernels")
    for name, r in rec.items():
        print("%s: max_abs_err %.3g, %s" % (name, r["max_abs_err"], json.dumps(
            {k: v for k, v in r.items() if k.endswith("ms") or k == "shape"})))
    profile_dir = (os.path.join(ROOT, "chiprun_out")
                   if "--profile" in sys.argv[1:] else None)
    served, eng, scope = serve_gpt2_small(dev)
    for n_slots in (3, 1):  # a one-slot pool has a one-row QStart
        card_matches_cpu(dev, n_slots, narrow_gpt2_config(), SERVING_KERNELS)
    if profile_dir:
        profile_serving(eng, scope, profile_dir)
    del eng, scope
    lap("gpt2 serving")
    torch.cuda.empty_cache()
    trained = train_transformer_base(dev, profile_dir)
    train_card_matches_cpu(dev)
    lap("wmt training")
    torch.cuda.empty_cache()
    trained_gpt2 = train_gpt2_small(dev, profile_dir)
    gpt2_train_card_matches_cpu(dev)
    lap("gpt2 training")
    torch.cuda.empty_cache()
    served_llama, eng, scope = serve_tinyllama(dev)
    for n_slots in (3, 1):
        card_matches_cpu(dev, n_slots, narrow_modern_config(),
                         SERVING_KERNELS + ("matmul_swiglu",
                                            "fused_layer_norm"))
    if profile_dir:
        profile_serving(eng, scope, profile_dir, name="serving_llama")
    del eng, scope
    lap("llama serving")
    torch.cuda.empty_cache()
    trained_llama = train_tinyllama(dev, profile_dir)
    llama_train_card_matches_cpu(dev)
    lap("llama training")
    torch.cuda.empty_cache()
    trained_bert = train_bert_base(dev, profile_dir)
    bert_train_card_matches_cpu(dev)
    lap("bert training")
    torch.cuda.empty_cache()
    trained_wmt_fused = train_transformer_base_fused_attn(dev)
    train_card_matches_cpu(dev, fused_attn=True)
    lap("wmt fused_attn training")
    torch.cuda.empty_cache()
    decoded = decode_gpt2_small(dev, profile_dir)
    lap("gpt2 decode")
    decode_card_matches_cpu(dev, narrow_gpt2_config(), DECODE_KERNELS)
    lap("narrow gpt2 decode, card vs CPU")
    torch.cuda.empty_cache()
    decoded_llama = decode_tinyllama(dev, profile_dir)
    lap("llama decode")
    decode_card_matches_cpu(dev, narrow_modern_config(),
                            DECODE_KERNELS + ("matmul_swiglu",
                                              "fused_layer_norm"))
    lap("narrow modern decode, card vs CPU")
    torch.cuda.empty_cache()
    trained_lstm = train_stacked_lstm(dev, profile_dir)
    lstm_train_card_matches_cpu(dev)
    lap("lstm training")
    trained_s2s = train_seq2seq(dev, profile_dir)
    seq2seq_train_card_matches_cpu(dev)
    lap("seq2seq training")
    decoded_s2s = decode_seq2seq(dev)
    seq2seq_decode_card_matches_cpu(dev)
    lap("seq2seq beam decode")
    torch.cuda.empty_cache()
    trained_packed = train_packed_lm(dev, 0, profile_dir)
    lap("packed LM training")
    torch.cuda.empty_cache()
    trained_packed_window = train_packed_lm(dev, PACKED_WINDOW, profile_dir)
    lap("packed LM training, window %d" % PACKED_WINDOW)
    packed_train_card_matches_cpu(dev)
    lap("narrow packed LM, card vs CPU")
    torch.cuda.empty_cache()
    trained_vp = train_vocab_parallel(dev, smi, profile_dir)
    lap("wmt vocab-parallel training (2 ranks on one card)")

    # launches: each path's run, counted from 0 just before it and read
    # just after
    kernels = []
    for name, r in rec.items():
        by_path = {"serving": served[name], "wmt_training": trained[name],
                   "gpt2_training": trained_gpt2[name],
                   "llama_serving": served_llama[name],
                   "llama_training": trained_llama[name],
                   "bert_training": trained_bert[name],
                   "wmt_fused_attn_training": trained_wmt_fused[name],
                   "gpt2_decode": decoded[name],
                   "llama_decode": decoded_llama[name],
                   "lstm_training": trained_lstm[name],
                   "seq2seq_training": trained_s2s[name],
                   "seq2seq_decode": decoded_s2s[name],
                   "packed_lm_training": trained_packed[name],
                   "packed_lm_window_training": trained_packed_window[name],
                   "wmt_vocab_parallel_training": trained_vp[name]}
        entry = {"name": name, "route": r["route"], "source": r["source"],
                 "replaces": r["replaces"],
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path}
        assert entry["launches"] > 0 or name in OFF_PATH_KERNELS, (
            "kernel never launched", name)
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape"):
            entry[key] = r[key]
        for key in ("per_shape", "max_rel_err", "library_note"):
            if key in r:
                entry[key] = r[key]
        kernels.append(entry)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
