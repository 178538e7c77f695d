#!/usr/bin/env python3
"""A short on-card check of the recurrent kernels of paddle_tpu_torch:
builds the kernel library and, beside it, the step-split library
(scripts/recurrent_split.cu: the shipped kernels run for a prefix of each
step; scripts/recurrent_grid_sync.cu: the grid-sync form they replaced,
likewise), prints ptxas's register and spill lines for both, and then

- runs fused_lstm (B11) and fused_gru (B10) against their plain PyTorch
  versions at the recurrent paths' shapes (full and ragged lengths, T 1
  from a nonzero h0, H 200, 700, 16 and 130, 200 rows), printing for
  each the largest absolute difference, whether a rerun and a
  back-to-back pair of launches on one stream are bit-equal, and the
  device time of one call (device_ms);
- prints where a step goes at the paths' shapes (the LSTM's [32, 64,
  4 x 512], the seq2seq GRUs' [32, 50, 3 x 512], the decode encoder's
  [8, 50, 3 x 512]), for the grid-sync form and the shipped one: the
  barriers alone (the empty recurrence), with the stage, with the
  product, and the whole kernel, in ms a launch.

    python3 scripts/recurrent_kernel_check.py   # one CUDA card, nvcc
    python3 scripts/recurrent_kernel_check.py --checks-only
        # the checks, and the grid-sync form's split alone: no time of the
        # shipped kernels

It takes about a minute, most of it the builds: the quick first call for
a change to csrc/recurrent.cu before a full chip_smoke.py run.
chip_smoke.py imports step_split for the kernels line's floor_ms.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from paddle_tpu_torch.kernels import (  # noqa: E402
    build,
    fused_gru,
    fused_lstm,
    gru_seq_plain,
    lstm_seq_plain,
)
from paddle_tpu_torch.kernels.recurrent import (  # noqa: E402
    COUNTER_WORDS,
    rnn_plan,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SPLIT_SOURCES = [os.path.join(HERE, "recurrent_grid_sync.cu"),
                 os.path.join(HERE, "recurrent_split.cu")]
# (kind, B, T, H, ragged)
SHAPES = ((32, 64, 512, False), (32, 64, 512, True), (32, 50, 512, False),
          (8, 50, 512, False), (8, 1, 512, False), (5, 7, 200, True),
          (6, 9, 700, True), (200, 5, 512, True), (4, 12, 16, True),
          (3, 6, 130, True))
SPLIT_SHAPES = (("lstm", 32, 64, 512), ("gru", 32, 50, 512),
                ("gru", 8, 50, 512))
PARTS = ("barrier", "stage", "product", "whole")
# per-block flag barriers alone, beside the shipped arrival counter:
# relaxed polls and one fence; an acquire load a flag a poll
BARRIERS = ("barrier_flags", "barrier_flags_acquire_each")
# recurrent_split.cu's `parts` for each (whole is the shipped kernel)
SPLIT_CODES = {"barrier": 0, "stage": 1, "product": 2, "barrier_flags": 3,
               "barrier_flags_acquire_each": 4}

_P, _I = ctypes.c_void_p, ctypes.c_int
_split = {}


def _split_path():
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for path in SPLIT_SOURCES + build.sources() + [
            os.path.join(build.CSRC, "common.cuh"),
            os.path.join(build.CSRC, "tf32_mma.cuh")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build.BUILD_DIR,
                        "libptt_rnn_split_%s.so" % h.hexdigest()[:16])


def start_split_build():
    """Starts nvcc on the split library (None if it is built): returns
    (process, path)."""
    path = _split_path()
    if os.path.exists(path):
        return None, path
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared",
         "-o", path + ".tmp%d" % os.getpid()] + SPLIT_SOURCES,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path


def split_lib(started=None):
    """The loaded split library, built at first use; its ptxas log is in
    split_lib.log."""
    if "lib" in _split:
        return _split["lib"]
    proc, path = started or start_split_build()
    if proc is not None:
        out, _ = proc.communicate()
        split_lib.log = out
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on the split library:\n%s" % out)
        os.replace(path + ".tmp%d" % os.getpid(), path)
    lib = ctypes.CDLL(path)
    for name, argtypes in (
            ("ptt_grid_sync_lstm", (_P,) * 7 + (_I,) * 4 + (_P,)),
            ("ptt_grid_sync_gru", (_P,) * 6 + (_I,) * 4 + (_P,)),
            ("ptt_split_lstm", (_P,) * 9 + (_I,) * 11 + (_P,)),
            ("ptt_split_gru", (_P,) * 7 + (_I,) * 11 + (_P,))):
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _I
    _split["lib"] = lib
    return lib


split_lib.log = ""


def _call(fn, *args):
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    rc = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d" % (fn.__name__, rc))


def device_ms(fn, reps=10):
    """Device ms of one call of `fn`, without the host's per-call cost:
    after a warm-up, the `reps` calls are queued behind a spin kernel
    (torch.cuda._sleep) that outlasts their enqueue, so the device runs
    them back to back between two CUDA events.  (Timed as they are
    issued, a 0.3 ms recurrent kernel measures the wrappers' Python.)"""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s * reps + 1e-3)))  # ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_split(kind, b, t, h, reps=10, seed=0,
               forms=("grid_sync", "shipped")):
    """Device ms a launch at full lengths for each prefix of a step
    (PARTS), in the grid-sync form and the shipped one, those of
    `forms`: {"grid_sync": {...}, "shipped": {...}}, and for the shipped
    form two barriers of per-block flags alone (BARRIERS).  Every launch
    of the shipped form is preceded by the zeroing of its workspace (as
    fused_lstm / fused_gru do; here a word a block, for the flags), the
    grid-sync form's by nothing."""
    lib = split_lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    gates = 4 if kind == "lstm" else 3
    x = torch.randn(b, t, gates * h, generator=g, device=dev)
    w = torch.randn(h, gates * h, generator=g, device=dev) * h ** -0.5
    h0 = torch.randn(b, h, generator=g, device=dev)
    c0 = torch.randn(b, h, generator=g, device=dev)
    lens = torch.full((b,), t, dtype=torch.int32, device=dev)
    hs = torch.empty(b, t, h, device=dev)
    cs = torch.empty_like(hs)
    scratch = torch.empty(2, b, h, device=dev)
    plan = rnn_plan(b, h, gates)
    hp = 4 * -(-h // 4)
    # a word a block for the flag barriers, at least the wrapper's counter
    # room (COUNTER_WORDS), so the exchange starts where fused_lstm's does
    n_flags = max(COUNTER_WORDS, 64 * -(-h // (64 * plan.units)))
    shipped = build.load()
    out = {form: {} for form in forms}
    for i, part in enumerate(PARTS + BARRIERS):
        if kind == "lstm":
            def old():
                _call(lib.ptt_grid_sync_lstm, x, w, h0, c0, lens, hs, cs, b,
                      t, h, i)
        else:
            def old():
                _call(lib.ptt_grid_sync_gru, x, w, h0, lens, hs, scratch, b,
                      t, h, i)

        def new():
            ws = torch.zeros(n_flags + 2 * b * hp, device=dev)
            xch, flags = ws[n_flags:], ws[:n_flags]
            if kind == "lstm":
                args = (x, w, h0, c0, lens, hs, cs, xch, flags, b, t, h,
                        *plan)
                fn = (shipped.ptt_lstm_seq if part == "whole"
                      else lib.ptt_split_lstm)
            else:
                args = (x, w, h0, lens, hs, xch, flags, b, t, h, *plan)
                fn = (shipped.ptt_gru_seq if part == "whole"
                      else lib.ptt_split_gru)
            _call(fn, *args, *(() if part == "whole"
                                 else (SPLIT_CODES[part],)))

        for form, fn in (("grid_sync", old), ("shipped", new)):
            if form in forms and (form == "shipped" or part in PARTS):
                out[form][part] = device_ms(fn, reps)
    return out


def _ptxas(log, source):
    part = log[log.find("== " + source):].split("\n== ")[0] if source else log
    return [ln.strip() for ln in part.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def main():
    if not torch.cuda.is_available():
        print("recurrent_kernel_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    checks_only = "--checks-only" in sys.argv[1:]
    t0 = time.time()
    started = start_split_build()
    build.load()
    split_lib(started)
    print("built in %.1f s" % (time.time() - t0))
    for line in _ptxas(build.build_log, "recurrent.cu") + _ptxas(
            split_lib.log, None):
        print("  " + line)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    worst, equal = 0.0, True
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
            worst = max(worst, err)
            bit = all(torch.equal(a, c) for a, c in zip(got, run()))
            first, second = run(), run()  # back to back, no sync between
            pair = all(torch.equal(a, c) and torch.equal(a, d)
                       for a, c, d in zip(got, first, second))
            equal = equal and bit and pair
            print(json.dumps(dict(
                kind="lstm" if gates == 4 else "gru", B=b, T=t, H=h,
                lens="ragged" if ragged else "full",
                plan=list(rnn_plan(b, h, gates)), max_abs_err=err,
                bit_equal_rerun=bit, bit_equal_back_to_back=pair,
                ms=None if checks_only else device_ms(run, 10))))
    forms = ("grid_sync",) if checks_only else ("grid_sync", "shipped")
    for kind, b, t, h in SPLIT_SHAPES:
        print(json.dumps(dict(step_split=kind, B=b, T=t, H=h,
                              **step_split(kind, b, t, h, forms=forms))))
    print("largest abs error against the plain scans: %.3g" % worst)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    if worst > 1e-5 or not equal:
        print("FAILED: error over 1e-5 or a rerun not bit-equal",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
