"""Op registry: op type -> PyTorch lowering rule (the counterpart of
``paddle_tpu/core/registry.py``).

Each op registers one lowering: a plain function from input tensors
(``{slot: [tensor]}``) plus static attrs to output tensors.  The same
rule runs the op in the executor and, on ``meta`` tensors, infers its
output shapes at build time (``layer_helper.infer_shape``).  This
module holds forward lowerings only; ``<type>_grad`` ops arrive with
the training slice.
"""

import torch

__all__ = ["register", "get_op", "is_registered", "LowerCtx", "OPS"]


class OpDef:
    def __init__(self, type, lower):
        self.type = type
        self.lower = lower  # fn(ctx, ins, attrs) -> {slot: [tensors]}


OPS = {}


def register(type_):
    """Decorator: register a lowering rule for op `type_`."""

    def deco(fn):
        OPS[type_] = OpDef(type_, fn)
        return fn

    return deco


def get_op(type_):
    if type_ not in OPS:
        raise NotImplementedError(
            "op '%s' has no PyTorch lowering registered (known: %d ops)"
            % (type_, len(OPS)))
    return OPS[type_]


def is_registered(type_):
    return type_ in OPS


_MASK64 = 0xFFFFFFFFFFFFFFFF


def _mix64(z):
    """splitmix64 finalizer: a full-avalanche 64-bit mix."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_seed(seed, *data):
    """Fold integers into a seed, order-sensitive (the counterpart of
    jax.random.fold_in on the reference's threefry keys)."""
    z = _mix64(int(seed) & _MASK64)
    for d in data:
        z = _mix64(z ^ _mix64(int(d) & _MASK64))
    return z & 0x7FFFFFFFFFFFFFFF


class LowerCtx:
    """Per-run context handed to lowering rules: the run's base seed
    (the executor folds in its step counter) and the device."""

    def __init__(self, seed=0, device=None):
        self.seed = int(seed)
        self.device = torch.device(device) if device is not None else None
        self.op_idx = 0

    def rng(self, attrs=None):
        """A seeded ``torch.Generator`` on the run's device for a
        randomness-consuming op.  A nonzero `seed` attr replaces the
        op-position fold, so ops sharing a seed share a stream (the
        reference's per-op seed-attr semantics).  The streams differ
        from the reference's threefry draws: parity tests feed both
        packages the same numpy inputs instead."""
        if self.device is not None and self.device.type == "meta":
            return None  # shape inference draws nothing
        seed = int(attrs.get("seed", 0)) if attrs else 0
        kind, value = (1, seed) if seed else (2, self.op_idx)
        g = torch.Generator(device=self.device or "cpu")
        g.manual_seed(fold_seed(self.seed, kind, value))
        return g
