"""Mesh-aware dispatch of the kernel lowerings (the counterpart of
``paddle_tpu/ops/spmd_epilogue.py``).

The reference wraps a kernel in ``shard_map`` when the rule table shards
its weight.  Here each rank already runs its own shard of the program
and holds its own slab of every sharded persistable (``executor.py``
places them), so a wrapper decides, from the op's weight name and the
live rule table, whether the rank's kernel needs a sharded form, and
runs it on the local operands:

1. resolve the op's weight name from the OpDesc being lowered
   (``ctx.block.ops[ctx.op_idx]``; the grad-side re-run of a forward
   rule sees the same block through ``lower_grad_op``);
2. look it up in the live rule table (``current_spmd``) with the
   declared shape;
3. run the sharded kernel, or return None, and the caller runs the
   unwrapped kernel: always with no mesh or a mesh of one rank, so a
   stamped program on such a mesh runs exactly as the unstamped one.

Ported: the vocab-sharded ``fused_linear_xent`` (``softmax_out.w`` P(None,
mp), or a tied ``emb.w`` P(mp, None) arriving transposed).  The
decisions of the other wrappers are ported, and under a table that
replicates their weights with dp 1 they decline as in the reference;
their sharded branches, and every dp-rows branch, are ROADMAP A7.
"""

from ..kernels.sharded_linear_xent import sharded_linear_xent
from ..parallel.mesh import mesh_axis_sizes
from ..parallel.partition_rules import current_spmd

__all__ = [
    "mesh_ctx", "op_weight_name", "spmd_matmul_bias_act",
    "spmd_matmul_swiglu", "spmd_add_layer_norm", "spmd_linear_xent",
]


def mesh_ctx():
    """(mesh, rules, mp_axis, nsh, dp_axis, ndp) inside a live
    spmd_lowering context with something to shard over, else None."""
    spmd = current_spmd()
    if spmd is None:
        return None
    mesh, rules = spmd
    sizes = mesh_axis_sizes(mesh)
    mp = rules.mp_axis
    nsh = int(sizes.get(mp, 1))
    dp_axis = getattr(rules, "dp_axis", None)
    ndp = int(sizes.get(dp_axis, 1)) if dp_axis else 1
    if nsh <= 1 and ndp <= 1:
        return None
    return mesh, rules, mp, nsh, dp_axis, ndp


def op_weight_name(ctx, expected_type, slot):
    """The var name feeding `slot` of the op being lowered, resolved
    through ctx.block + ctx.op_idx ((block_idx << 20) | idx in the
    forward run, the plain forward index on the grad-side re-run).  None
    when the context carries no block or the op type disagrees: callers
    run the unwrapped kernel then."""
    blk = getattr(ctx, "block", None)
    if blk is None:
        return None
    idx = int(getattr(ctx, "op_idx", 0)) & ((1 << 20) - 1)
    if idx >= len(blk.ops):
        return None
    op = blk.ops[idx]
    if op.type != expected_type:
        return None
    names = op.inputs.get(slot)
    return names[0] if names else None


def _dim_has(spec, d, axis):
    """Does spec `spec` place mesh axis `axis` on dim `d`?"""
    if spec is None or len(spec) <= d:
        return False
    e = tuple(spec)[d]
    return e == axis or (isinstance(e, tuple) and axis in e)


def _row_axis(dp_axis, ndp, rows):
    """The activation-rows mesh axis: the dp axis when it exists and
    divides the row count, else None (rows replicate)."""
    return dp_axis if (dp_axis and ndp > 1 and rows % ndp == 0) else None


def _declared_shape(ctx, name):
    var = ctx.block._find_var_recursive(name)
    return tuple(int(d) for d in var.shape) if var is not None else None


def _not_ported(what):
    raise NotImplementedError(
        "%s under a mesh is not ported yet (ROADMAP A7)" % what)


def spmd_matmul_bias_act(ctx, x2, w, bias, act):
    """Mesh-aware matmul_bias_act: column-parallel (w P(., mp)),
    row-parallel (w P(mp, .)) or replicated w with dp-sharded rows in the
    reference; None -> the unwrapped kernel."""
    mc = mesh_ctx()
    if mc is None:
        return None
    _, rules, mp, nsh, dp_axis, ndp = mc
    wname = op_weight_name(ctx, "fc", "W")
    if wname is None:
        return None
    spec = rules.spec_for(wname, _declared_shape(ctx, wname))
    M, K = x2.shape
    N = w.shape[1]
    row = _row_axis(dp_axis, ndp, M)
    col_par = nsh > 1 and _dim_has(spec, 1, mp) and N % nsh == 0
    row_par = nsh > 1 and _dim_has(spec, 0, mp) and K % nsh == 0
    if col_par or row_par:
        _not_ported("a column- or row-parallel fc")
    if row is not None:
        _not_ported("fc over dp-sharded rows")
    return None


def spmd_matmul_swiglu(ctx, x2, wg, wu):
    """Mesh-aware matmul_swiglu: column-parallel when both weights carry
    P(., mp), else rows-only when dp divides, in the reference."""
    mc = mesh_ctx()
    if mc is None:
        return None
    _, rules, mp, nsh, dp_axis, ndp = mc
    gname = op_weight_name(ctx, "fused_swiglu", "GateW")
    uname = op_weight_name(ctx, "fused_swiglu", "UpW")
    if gname is None or uname is None:
        return None
    gspec = rules.spec_for(gname, _declared_shape(ctx, gname))
    uspec = rules.spec_for(uname, _declared_shape(ctx, uname))
    row = _row_axis(dp_axis, ndp, x2.shape[0])
    col_par = (nsh > 1 and wg.shape[1] % nsh == 0
               and _dim_has(gspec, 1, mp) and _dim_has(uspec, 1, mp))
    if col_par:
        _not_ported("a column-parallel fused_swiglu")
    if row is None or _dim_has(gspec, 1, mp) or _dim_has(uspec, 1, mp):
        return None
    _not_ported("fused_swiglu over dp-sharded rows")


def spmd_add_layer_norm(ctx, x2, y2, gamma, beta, eps):
    """Mesh-aware fused_add_layer_norm: rows shard over dp in the
    reference (the hidden axis never shards)."""
    mc = mesh_ctx()
    if mc is None:
        return None
    _, _, _, _, dp_axis, ndp = mc
    if _row_axis(dp_axis, ndp, x2.shape[0]) is not None:
        _not_ported("fused_residual_ln over dp-sharded rows")
    return None


def spmd_linear_xent(ctx, x2, w, labels, eps, transpose_w):
    """Mesh-aware fused_linear_xent: when the projection weight is
    vocab-sharded, this rank runs ``sharded_linear_xent`` on its own
    [H, V/n] slab, and the shards' parts combine by per-row all-reduces
    over the mp axis.  `w` is the rank's value ALREADY transposed to
    [H, V/n]; `transpose_w` says which dim of the DECLARED weight is the
    vocab.  None -> the unwrapped kernel."""
    mc = mesh_ctx()
    if mc is None:
        return None
    mesh, rules, mp, nsh, dp_axis, ndp = mc
    wname = op_weight_name(ctx, "fused_linear_xent", "W")
    if wname is None:
        return None
    decl_shape = _declared_shape(ctx, wname)
    spec = rules.spec_for(wname, decl_shape)
    vdim = 0 if transpose_w else 1
    R, H = x2.shape
    V = decl_shape[vdim]
    if _dim_has(spec, 1 - vdim, mp):
        return None  # hidden-sharded projection: not a supported layout
    vocab_sharded = nsh > 1 and _dim_has(spec, vdim, mp) and V % nsh == 0
    if _row_axis(dp_axis, ndp, R) is not None:
        _not_ported("fused_linear_xent over dp-sharded rows")
    if not vocab_sharded:
        return None
    v_local = V // nsh
    if tuple(w.shape) != (H, v_local):
        raise ValueError(
            "fused_linear_xent: %s is declared %s and vocab-sharded over %s "
            "= %d, so this rank holds [%d, %d], but it got %s" % (
                wname, decl_shape, mp, nsh, H, v_local, tuple(w.shape)))
    return sharded_linear_xent(x2, w, labels, eps, mesh.group(mp),
                               mesh.index(mp) * v_local, V)
