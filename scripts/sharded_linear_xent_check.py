#!/usr/bin/env python3
"""A short on-card check of sharded_linear_xent (B12) and the linear
cross-entropy kernels it shares its tiles with: builds the kernel
library, prints ptxas's spill lines, holds B4 (`fused_linear_xent`'s
forward, dx and dw) against its plain version at four shapes, runs
`chip_smoke.check_sharded_linear_xent` (B12's parts, dx and dw against
their plain versions, timed) and its bf16 forms
(`bf16_kernels_check.check_sharded_linear_xent`, timed), and then spawns
two ranks on the one card over gloo that check the collectives on CUDA
tensors (all-reduce sum and max, in float32 and a bf16 sum, broadcast,
the host-staged all-gather) and run `sharded_linear_xent` under
`torch.func.vjp` against the unsharded `fused_linear_xent`, in float32
and in bf16.

    python3 scripts/sharded_linear_xent_check.py [--train [--profile]]

It takes under a minute, most of it the build: the quick first call for
a change to csrc/linear_xent.cu, csrc/linear_xent_bf16.cu or the
collectives before a full chip_smoke.py run.  `--train` then runs
`chip_smoke.train_vocab_parallel` (both legs of the vocab-parallel
training phase, ~90 s), and `--profile` profiles each leg's rank 0
(chiprun_out/profile_training_vocab_parallel[_bf16].json): the busy ms
and idle share of the capture lines.
"""

import json
import multiprocessing
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

B4_SHAPES = ((4096, 512, 10000, 0.1), (100, 512, 1007, 0.1),
             (70, 600, 300, 0.1), (4096, 2048, 32000, 0.0))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _rank(rank, store, out_dir):
    """One of two ranks on cuda:0: the collectives, then the combine and
    its vjp on this rank's vocab slab against the unsharded kernel."""
    from paddle_tpu_torch.kernels import fused_linear_xent, sharded_linear_xent
    from paddle_tpu_torch.parallel import collective, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    collective.init_distributed_env("file://" + store, 2, rank,
                                    backend="gloo")
    group = make_mesh({"dp": 1, "mp": 2}).group("mp")
    dev = torch.device("cuda", 0)
    x = torch.tensor([1.0 + rank, -float(rank)], device=dev)
    # rank 0's 1 and rank 1's 1 + 2^-7 are bf16 values, their sum 2 + 2^-7
    # is not: a bf16 sum rounds it to 2
    y = torch.tensor([1.0 + rank * 2.0 ** -7], device=dev,
                     dtype=torch.bfloat16)
    out = {"sum": collective.all_reduce(x, group).tolist(),
           "max": collective.all_reduce(x, group, "max").tolist(),
           "sum_bf16": collective.all_reduce(y, group).float().tolist(),
           "broadcast": collective.broadcast(x, group, 1).tolist(),
           "all_gather": collective.all_gather(x, group).tolist()}
    g = torch.Generator(device=dev).manual_seed(0)
    R, H, V, eps = 1000, 512, 2000, 0.1
    xx = torch.randn(R, H, generator=g, device=dev)
    w = torch.randn(H, V, generator=g, device=dev) * H ** -0.5
    lbl = torch.randint(0, V, (R,), generator=g, device=dev)
    lbl[0], lbl[1] = -1, V
    dy = torch.rand(R, 1, generator=g, device=dev)
    vl = V // 2
    wl = w[:, rank * vl:(rank + 1) * vl].contiguous()
    loss, vjp = torch.func.vjp(lambda a, b: sharded_linear_xent(
        a, b, lbl, eps, group, rank * vl, V), xx, wl)
    dx, dw = vjp(dy)
    r_loss, r_vjp = torch.func.vjp(
        lambda a, b: fused_linear_xent(a, b, lbl, eps), xx, w)
    r_dx, r_dw = r_vjp(dy)
    out.update(loss_rel=_rel(loss, r_loss), dx_rel=_rel(dx, r_dx),
               dw_rel=_rel(dw, r_dw[:, rank * vl:(rank + 1) * vl]))
    # bf16: dx and dw against the unsharded bf16 kernels' (g rounded to
    # bf16 where a logit differs in its last bits; dx's partials summed in
    # bf16)
    xb, wb = xx.to(torch.bfloat16), w.to(torch.bfloat16)
    loss, vjp = torch.func.vjp(lambda a, b: sharded_linear_xent(
        a, b, lbl, eps, group, rank * vl, V), xb,
        wb[:, rank * vl:(rank + 1) * vl].contiguous())
    dx, dw = vjp(dy)
    r_loss, r_vjp = torch.func.vjp(
        lambda a, b: fused_linear_xent(a, b, lbl, eps), xb, wb)
    r_dx, r_dw = r_vjp(dy)
    out.update(bf16_dtypes=[str(t.dtype) for t in (loss, dx, dw)],
               bf16_loss_rel=_rel(loss, r_loss),
               bf16_dx_rel=_rel(dx.float(), r_dx.float()),
               bf16_dw_rel=_rel(dw.float(), r_dw[:, rank * vl:(rank + 1) * vl]
                                .float()))
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)


def main():
    if not torch.cuda.is_available():
        print("sharded_linear_xent_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bf16_kernels_check
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import linear_xent as lx

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.load()
    print("built in %.1f s" % (time.time() - t0))
    log = build.build_log
    print(log[log.find("== linear_xent"):].split("\n== ")[0])
    print(log[log.find("== linear_xent_bf16"):].split("\n== ")[0])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    for r, h, v, eps in B4_SHAPES:
        x, w = randn(r, h), randn(h, v, scale=h ** -0.5)
        lbl = torch.randint(0, v, (r,), generator=g, device=dev)
        lbl[0], lbl[1] = -1, v
        dy = torch.rand(r, 1, generator=g, device=dev)
        loss, lse = lx.linear_xent_fwd(x, w, lbl, eps)
        p_loss, p_lse = lx.linear_xent_plain(x, w, lbl, eps)
        p_dx, p_dw = lx.linear_xent_grad_plain(x, w, lbl, p_lse, dy, eps)
        print(json.dumps(dict(
            kernel="fused_linear_xent", R=r, H=h, V=v, eps=eps,
            loss_rel=_rel(loss, p_loss),
            dx_rel=_rel(lx.linear_xent_dx(x, w, lbl, lse, dy, eps), p_dx),
            dw_rel=_rel(lx.linear_xent_dw(x, w, lbl, lse, dy, eps), p_dw))))
    t0 = time.time()
    rec = chip_smoke.check_sharded_linear_xent(dev, randn, g)
    print("sharded_linear_xent checked in %.1f s" % (time.time() - t0))
    print(json.dumps(rec, indent=1))
    rec = bf16_kernels_check.check_sharded_linear_xent(chip_smoke, dev, randn,
                                                        g)
    print(json.dumps(rec, indent=1))

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank,
                             args=(r, os.path.join(d, "store"), d))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        for r in range(2):
            path = os.path.join(d, "rank%d.json" % r)
            if os.path.exists(path):
                with open(path) as f:
                    print("rank %d: %s" % (r, f.read()))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi)
    if codes != [0, 0]:
        print("sharded_linear_xent_check: ranks exited %s" % codes,
              file=sys.stderr)
        return 1
    if "--train" in sys.argv[1:]:
        t0 = time.time()
        chip_smoke.train_vocab_parallel(
            dev, smi, os.path.join(ROOT, "chiprun_out")
            if "--profile" in sys.argv[1:] else None)
        print("vocab-parallel training phase, both legs: %.1f s"
              % (time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
