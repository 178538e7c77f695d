#!/usr/bin/env python3
"""Times every form that the two row kernels can take, at the paths'
shapes and the forms' edges on the card, and prints each plan
function's pick beside the fastest and beside the form it replaced:

- fused_add_layer_norm (B2, csrc/add_layer_norm.cu): the row over 1, 2,
  4 and 8 warps (the fewest float4 slots a lane that hold it), at
  add_ln_plan's rows a block, against add_ln_plan's pick and the block
  form it replaced (scripts/row_forms_before.cu), with
  F.layer_norm(x + y) beside;
- fused_softmax_xent (B7, csrc/softmax_xent.cu), forward and backward:
  the warp form, the staged form at
  1, 2, 4 and 8 blocks a row and 128 to 1024 threads a block, and the
  two-read row form, against sxent_plan's pick and the forms they
  replaced (a warp a row with 32 slots a lane to C 1024, the two-read
  form beyond), with F.cross_entropy beside.

Each form is launched through build.launch with its own plan ints, as
scripts/decode_kernels_check.py does, and is first held against its
plain version (B2: 1e-5 absolute on s, the output, mean and variance;
B7: 1e-5 of the largest magnitude, labels -1 and C in the batch) with a
rerun bit-equal; the picks are also held bit-equal to themselves on the
first 7 rows alone (a row's result does not depend on R) and, for B2,
with float4 access off (the scalar form gives the same bits).  Times are
chip_smoke's (CUDA graph replays, the median of 5); bounds are bytes
over 3.35 TB/s.

    python3 scripts/row_kernels_check.py [--checks-only]

chip_smoke.py's kernel phase builds the replaced forms with
start_before_build / before_lib and times them beside the picks.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BEFORE_SOURCE = os.path.join(ROOT, "scripts", "row_forms_before.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BEFORE_SIGNATURES = {
    "ptt_before_add_layer_norm": (_P,) * 8 + (_I, _I, _F, _P),
    "ptt_before_softmax_xent_fwd": (_P,) * 3 + (_I, _I, _P),
    "ptt_before_softmax_xent_bwd": (_P,) * 4 + (_I, _I, _P),
}
_before = {}

# B2: the path shapes (chip_smoke's), ragged rows, the forms' edges
# (H 1024 the last of 8 slots a warp, 1025 a ninth slot, 2048, an H that
# is not a multiple of 4) and the widest row the plan takes
ADD_LN_EDGES = ((7, 768), (1, 768), (5, 512), (300, 1024), (300, 1025),
                (64, 2048), (33, 1027), (9, 770), (3, 16384), (5, 12288))
# B7: the warp form at 3, 17 and 33 columns and at its widest slots, ragged rows in the staged form, odd C at one and two blocks a
# row (main adds the widest staged row and the first two-read one)
SXENT_EDGES = ((37, 3), (9, 17), (5, 33), (1000, 1001), (37, 1500),
               (9, 4097), (6, 12345))


def _before_path():
    from paddle_tpu_torch.kernels import build

    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for path in (BEFORE_SOURCE, os.path.join(build.CSRC, "common.cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build.BUILD_DIR,
                        "libptt_row_forms_before_%s.so" % h.hexdigest()[:16])


def start_before_build():
    """Starts nvcc on the replaced forms' library (None if it is built):
    returns (process, path)."""
    from paddle_tpu_torch.kernels import build

    path = _before_path()
    if os.path.exists(path):
        return None, path
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared",
         "-o", path + ".tmp%d" % os.getpid(), BEFORE_SOURCE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path


def before_lib(started=None):
    """The loaded library of the replaced forms, built at first use; its
    ptxas log is in before_lib.log."""
    if "lib" in _before:
        return _before["lib"]
    proc, path = started or start_before_build()
    if proc is not None:
        out, _ = proc.communicate()
        before_lib.log = out
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on the replaced forms:\n%s" % out)
        os.replace(path + ".tmp%d" % os.getpid(), path)
    lib = ctypes.CDLL(path)
    for name, argtypes in BEFORE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _I
    _before["lib"] = lib
    return lib


before_lib.log = ""


def _call(name, *args):
    import torch

    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    rc = getattr(before_lib(), name)(*cargs,
                                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d" % (name, rc))


def _add_ln_outputs(x):
    import torch

    r = x.shape[0]
    return (torch.empty_like(x), torch.empty_like(x),
            torch.empty(r, device=x.device), torch.empty(r, device=x.device))


def before_add_ln(x, y, gam, bet, eps=1e-5):
    """(s, out, mean, var) of the replaced block form."""
    outs = _add_ln_outputs(x)
    _call("ptt_before_add_layer_norm", x, y, gam, bet, *outs, *x.shape,
          float(eps))
    return outs


def before_sxent(kind, x, lbl, dy=None):
    """The replaced forms' loss (kind "fwd") or dx ("bwd")."""
    import torch

    if kind == "fwd":
        loss = torch.empty(x.shape[0], 1, device=x.device)
        _call("ptt_before_softmax_xent_fwd", x, lbl, loss, *x.shape)
        return loss
    dx = torch.empty_like(x)
    _call("ptt_before_softmax_xent_bwd", x, lbl, dy, dx, *x.shape)
    return dx


def add_ln_launch(x, y, gam, bet, plan, eps=1e-5):
    """(s, out, mean, var) of B2's kernel at `plan` (n4, vec, warps,
    rows)."""
    from paddle_tpu_torch.kernels import build

    outs = _add_ln_outputs(x)
    build.launch("ptt_add_layer_norm", x, y, gam, bet, *outs, *x.shape,
                 *plan, float(eps))
    return outs


def add_ln_forms(r, h):
    """add_ln_plan's pick first, then the row over each of 1, 2, 4 and 8
    warps at the fewest slots a lane that hold it, at the plan's rule for
    rows a block."""
    from paddle_tpu_torch.kernels import add_layer_norm as aln

    pick = aln.add_ln_plan(r, h)
    out = [tuple(pick)]
    need = -(-h // 128)
    for warps in (1, 2, 4, 8):
        n4 = next((n for n in aln.N4_SLOTS if n * warps >= need), None)
        if n4 is None:
            continue
        plan = (n4, pick.vec, warps,
                max(1, min(aln.MAX_WARPS // warps, r // aln.SMS)))
        if plan not in out:
            out.append(plan)
    return out


def sxent_launch(kind, x, lbl, dy, plan):
    """B7's loss (kind "fwd") or dx ("bwd") at `plan` (form, ctas, threads,
    smem)."""
    import torch

    from paddle_tpu_torch.kernels import build

    r, c = x.shape
    if kind == "fwd":
        loss = torch.empty(r, 1, device=x.device)
        build.launch("ptt_softmax_xent_fwd", x, lbl, loss, *plan, r, c)
        return loss
    dx = torch.empty_like(x)
    build.launch("ptt_softmax_xent_bwd", x, lbl, dy, dx, *plan, r, c)
    return dx


def sxent_forms(r, c):
    """sxent_plan's pick first (the warp form alone at C <= 1024), then
    the staged form at each blocks a row and threads a block
    that hold at least a float4 a thread and the two-read form (C >
    1024)."""
    from paddle_tpu_torch.kernels import softmax_xent as sx

    pick = tuple(sx.sxent_plan(r, c))
    out = [pick]
    if c <= sx.WARP_MAX_C:
        return out
    for ctas in sx.CTAS:
        part = -(-c // ctas) + 3 & ~3
        if 4 * (part + 4) > sx.STAGE_BYTES or part < 1024:
            continue
        for threads in (128, 256, 512, 1024):
            plan = (sx.STAGED, ctas, threads, 4 * (part + 4))
            if 4 * threads <= part and plan not in out:
                out.append(plan)
    if (sx.TWO_READ, 0, 0, 0) not in out:
        out.append((sx.TWO_READ, 0, 0, 0))
    return out


def held_add_ln(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def held_sxent(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _key(plan):
    return "/".join(str(int(v)) for v in plan)


def check_add_ln(cs, randn, shapes, times=True):
    """Every B2 form at each (tag, R, H) against plain; returns the worst
    error.  Times the forms, the replaced block form and F.layer_norm(x
    + y) when `times`."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import add_layer_norm_plain
    from paddle_tpu_torch.kernels.add_layer_norm import add_ln_plan

    worst = 0.0
    for tag, r, h in shapes:
        x, y = randn(r, h), randn(r, h)
        gam, bet = randn(h), randn(h)
        want = add_layer_norm_plain(x, y, gam, bet, 1e-5)
        row = {}
        pick = tuple(add_ln_plan(r, h))
        for plan in add_ln_forms(r, h):
            got = add_ln_launch(x, y, gam, bet, plan)
            err = held_add_ln(got, want)
            worst = max(worst, err)
            assert err <= 1e-5, ("add-LN form disagrees", r, h, plan, err)
            assert all(torch.equal(a, b) for a, b in zip(
                got, add_ln_launch(x, y, gam, bet, plan))), (
                    "add-LN rerun differs", r, h, plan)
            if plan == pick:
                few = min(r, 7)
                part = add_ln_launch(x[:few], y[:few], gam, bet,
                                     add_ln_plan(few, h))
                assert all(torch.equal(a[:few], b) for a, b in zip(
                    got, part)), ("add-LN rows depend on R", r, h)
                if pick[1]:
                    scalar = add_ln_launch(x, y, gam, bet,
                                           pick[:1] + (0,) + pick[2:])
                    assert all(torch.equal(a, b) for a, b in zip(
                        got, scalar)), ("float4 and scalar differ", r, h)
            if times:
                row[_key(plan)] = cs._time_ms(
                    lambda: add_ln_launch(x, y, gam, bet, plan))
        if not times:
            continue
        # (its row and static scratch must fit the 48 KB default: H < 12256)
        err = held_add_ln(before_add_ln(x, y, gam, bet), want)
        assert err <= 1e-5, ("the replaced block form disagrees", r, h, err)
        before = cs._time_ms(lambda: before_add_ln(x, y, gam, bet))
        lib = cs._time_ms(lambda: F.layer_norm(x + y, (h,), gam, bet, 1e-5))
        bound, _ = cs._bound_ms(16 * r * h + 8 * h + 8 * r, 10 * r * h)
        best = min(row, key=row.get)
        print("B2 %s [%d, %d]: pick %s %.6f, fastest %s %.6f, block form "
              "%.6f, layer_norm(x + y) %.6f, bound %.6g; %s" % (
                  tag, r, h, _key(pick), row[_key(pick)], best, row[best],
                  before, lib, bound, json.dumps(row)), flush=True)
    return worst


def check_sxent(cs, randn, g, shapes, times=True):
    """Every B7 form at each (tag, R, C), forward and backward, against
    plain with labels -1 and C in the batch; returns the worst error.
    Times the forms, the replaced ones and F.cross_entropy when
    `times`."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import softmax_xent as sx

    worst = 0.0
    for tag, r, c in shapes:
        x = randn(r, c) * 3.0
        lbl = torch.randint(0, c, (r,), generator=g, device=x.device)
        dy = torch.rand(r, 1, generator=g, device=x.device)
        bad = lbl.clone()
        bad[0], bad[-1] = -1, c
        want = {"fwd": sx.softmax_xent_plain(x, bad),
                "bwd": sx.softmax_xent_grad_plain(x, bad, dy)}
        pick = tuple(sx.sxent_plan(r, c))
        others = {"before": before_sxent}
        rows = {"fwd": {}, "bwd": {}}
        for kind in ("fwd", "bwd"):
            for plan in sxent_forms(r, c):
                got = sxent_launch(kind, x, bad, dy, plan)
                err = held_sxent(got, want[kind])
                worst = max(worst, err)
                assert err <= 1e-5, ("sxent form disagrees", kind, r, c,
                                     plan, err)
                assert torch.equal(got, sxent_launch(kind, x, bad, dy, plan)), (
                    "sxent rerun differs", kind, r, c, plan)
                if plan == pick:
                    few = min(r, 7)
                    part = sxent_launch(kind, x[:few], bad[:few], dy[:few],
                                        sx.sxent_plan(few, c))
                    assert torch.equal(got[:few], part), (
                        "sxent rows depend on R", kind, r, c)
                if times:
                    rows[kind][_key(plan)] = cs._time_ms(
                        lambda: sxent_launch(kind, x, lbl, dy, plan))
            for name, fn in others.items():
                err = held_sxent(fn(kind, x, bad, dy), want[kind])
                assert err <= 1e-5, (name, "disagrees", kind, r, c, err)
                if times:
                    rows[kind][name] = cs._time_ms(
                        lambda: fn(kind, x, lbl, dy))
        if not times:
            continue
        xg = x.clone().requires_grad_()

        def library_fwd_bwd():
            loss = F.cross_entropy(xg, lbl, reduction="none")
            return torch.autograd.grad(loss, (xg,), dy.reshape(-1))

        lib = {"fwd": cs._time_ms(lambda: F.cross_entropy(
            x, lbl, reduction="none")),
            "bwd": cs._events_ms(library_fwd_bwd, reps=10)}
        for kind, nbytes in (("fwd", 4 * r * c + 12 * r),
                             ("bwd", 8 * r * c + 12 * r)):
            row = rows[kind]
            bound, _ = cs._bound_ms(nbytes, 4 * r * c)
            forms = {k: v for k, v in row.items() if k not in others}
            best = min(forms, key=forms.get)
            print("B7 %s %s [%d, %d]: pick %s %.6f, fastest %s %.6f, %s"
                  "library %.6f, bound %.6g; %s" % (
                      kind, tag, r, c, _key(pick), row[_key(pick)], best,
                      row[best], "".join("%s %.6f, " % (k, row[k])
                                         for k in others), lib[kind],
                      bound, json.dumps(row)), flush=True)
    return worst


def ptxas_lines(log, names):
    """ptxas's entry, register and spill lines for kernels whose names
    contain one of `names`."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(n in line for n in names)
        if keep and ("Compiling entry" in line or "registers" in line
                     or "spill" in line):
            out.append("  " + line.strip())
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("row_kernels_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import softmax_xent as sx

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    started = start_before_build()
    build.load()
    before_lib(started)
    for source, names in (("add_layer_norm.cu", ("add_ln",)),
                          ("softmax_xent.cu", ("sxent",))):
        log = build.build_log
        part = log[log.find("== " + source):].split("\n== ")[0]
        print(source, flush=True)
        print("\n".join(ptxas_lines(part, names)), flush=True)
    print("row_forms_before.cu", flush=True)
    print("\n".join(ptxas_lines(before_lib.log, ("add_ln", "sxent"))),
          flush=True)
    times = "--checks-only" not in sys.argv[1:]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    serve = cs.N_SLOTS * cs.WIDTH
    path = ((("serve", serve, 768), ("wmt_train", cs.TRAIN_ROWS,
                                     cs.HP_D_MODEL),
             ("gpt2_train", cs.GPT2_ROWS, cs.GPT2_D),
             ("llama_train", cs.LLAMA_ROWS, cs.LLAMA_D),
             ("llama_serve", serve, cs.LLAMA_D),
             ("bert_train", cs.BERT_ROWS, cs.BERT_D)) + cs.DECODE_ROWS)
    worst = check_add_ln(cs, randn, path, times)
    worst = max(worst, check_add_ln(
        cs, randn, [("edge",) + s for s in ADD_LN_EDGES], False))
    # a view that does not start on 16 bytes takes the scalar form
    from paddle_tpu_torch.kernels import (add_layer_norm_plain,
                                          fused_add_layer_norm)
    x = randn(5 * 768 + 1)[1:].view(5, 768)
    y, gam, bet = randn(5, 768), randn(768), randn(768)
    err = held_add_ln(fused_add_layer_norm(x, y, gam, bet),
                      add_layer_norm_plain(x, y, gam, bet))
    assert err <= 1e-5, ("add-LN misaligned view", err)
    worst = max(worst, err)
    print("B2 checked: worst error %.3g" % worst, flush=True)
    sx_path = (("nsp", cs.BERT_BATCH, 2), ("c1024", 4096, 1024),
               ("c1025", 4096, 1025), ("c4098", 4096, 4098),
               ("mlm", cs.BERT_ROWS, cs.BERT_VOCAB),
               ("gpt2_vocab", 1024, cs.GPT2_VOCAB))
    worst = check_sxent(cs, randn, g, sx_path, times)
    worst = max(worst, check_sxent(
        cs, randn, g, [("edge",) + s for s in SXENT_EDGES]
        + [("widest_staged", 3, sx.STAGED_MAX_C),
           ("first_two_read", 2, sx.STAGED_MAX_C + 1)], False))
    # a view that does not start on 16 bytes: the staged form's scalar dx
    x = randn(9 * 4098 + 1)[1:].view(9, 4098)
    lbl = torch.randint(0, 4098, (9,), generator=g, device=dev)
    dy = torch.rand(9, 1, generator=g, device=dev)
    for kind, got, want in (
            ("fwd", sx.softmax_xent_fwd(x, lbl), sx.softmax_xent_plain(x, lbl)),
            ("bwd", sx.softmax_xent_bwd(x, lbl, dy),
             sx.softmax_xent_grad_plain(x, lbl, dy))):
        err = held_sxent(got, want)
        assert err <= 1e-5, ("sxent misaligned view", kind, err)
        worst = max(worst, err)
    print("B7 checked: worst error %.3g" % worst, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
