"""Partition-rule registry: persistable var names -> partition specs (the
counterpart of ``paddle_tpu/parallel/partition_rules.py``).

An ordered (regex, spec) table, FIRST match wins, resolved per var name,
so a whole model family picks up its tensor-parallel placements with no
per-model edits.  A spec is ``P``: one entry per dim, each a mesh axis
name, a tuple of names, or None (that dim is not split).

- Per-model-family tables (``register_partition_rules`` /
  ``partition_rules_for``), and ``TrainPartitionRules``, which resolves
  grads, optimizer accumulators and bf16 cast mirrors through their
  param's rule.
- Replicate-by-default that LOGS: every name that falls through to
  replication is recorded in ``replicated_log``.
- An SPMD lowering context (``spmd_lowering`` / ``current_spmd``) the op
  lowerings consult while the executor runs a stamped program.

Where the reference places a global array on a device mesh
(``NamedSharding``), each rank of the port holds its own slab:
``sharding_for`` says which (the dim, this rank's slab index and the slab
size), with the same guards.  Pipeline stage ownership
(``StageResolution``) is not ported (ROADMAP A7).
"""

import logging
import math
import re
import threading
from contextlib import contextmanager

__all__ = [
    "P", "PartitionRules", "TrainPartitionRules", "LocalSlice",
    "register_partition_rules", "partition_rules_for",
    "train_partition_rules_for", "registered_families", "annotate_spmd",
    "spmd_lowering", "current_spmd",
]

log = logging.getLogger("paddle_tpu_torch.parallel.partition_rules")


class P(tuple):
    """A partition spec: ``P(None, "mp")`` splits dim 1 over mesh axis
    ``mp``; ``P()`` replicates.  Compares equal to the plain tuple of
    its entries."""

    def __new__(cls, *entries):
        return super(P, cls).__new__(cls, entries)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self) if len(self) != 1
                        else "(%r)" % (self[0],))


class LocalSlice:
    """This rank's part of a var: dim `dim` cut over mesh axis `axis`
    into slabs of `size`, this rank holding slab `index` (elements
    index * size ... + size)."""

    def __init__(self, dim, axis, index, size, full_shape):
        self.dim, self.axis, self.index, self.size = dim, axis, index, size
        self.full_shape = tuple(full_shape)

    @property
    def start(self):
        return self.index * self.size

    @property
    def shape(self):
        s = list(self.full_shape)
        s[self.dim] = self.size
        return tuple(s)


class PartitionRules:
    """Ordered (regex, P) table; ``spec_for`` resolves a var name (first
    match wins) with guards that REPLICATE and record why instead of
    failing:

    - scalar guard: 0-d / 1-element values never shard;
    - rank guard: a spec with more entries than the value has dims
      replicates (optimizer counters sharing a param's name prefix);
    - divisibility guard (``sharding_for``, mesh-aware): a dim that does
      not divide by its axis size replicates.

    Unmatched names fall through to replicated and are logged once per
    name."""

    def __init__(self, rules=None, mp_axis="mp"):
        self.mp_axis = mp_axis
        self.rules = [(pat, re.compile(pat), spec)
                      for pat, spec in (rules or [])]
        # (name, reason) for every replicate-fallback decision, in
        # resolution order, once per name
        self.replicated_log = []
        self._logged = set()

    def add(self, pattern, spec):
        self.rules.append((pattern, re.compile(pattern), spec))
        return self

    def match(self, name):
        """(spec, pattern) of the FIRST rule matching `name`;
        (None, None) when no rule matches."""
        for pat, cre, spec in self.rules:
            if cre.search(name):
                return spec, pat
        return None, None

    def _fallback(self, name, reason):
        if name not in self._logged:
            self._logged.add(name)
            self.replicated_log.append((name, reason))
            log.info("partition_rules: replicating %r (%s)", name, reason)
        return P()

    def spec_for(self, name, shape=None):
        if shape is not None and (len(shape) == 0
                                  or math.prod(int(d) for d in shape) <= 1):
            return P()  # scalar guard: never worth logging
        spec, pat = self.match(name)
        if spec is None:
            return self._fallback(name, "no rule matched")
        if shape is not None and len(spec) > len(shape):
            return self._fallback(
                name, "rank %d < rule %r spec %s" % (len(shape), pat, spec))
        return spec

    def sharding_for(self, mesh, name, shape):
        """This rank's slab of `name` (declared `shape`) under `mesh`, or
        None when it is replicated: ``spec_for`` plus the divisibility
        guard.  The port splits one dim over one axis; an axis of size 1
        splits nothing, and a spec splitting two dims, or one dim over
        two axes of size > 1, raises (ROADMAP A7)."""
        spec = self.spec_for(name, shape)
        cut = []
        for dim, (extent, axes) in enumerate(zip(shape, tuple(spec))):
            if axes is None:
                continue
            for ax in (axes if isinstance(axes, tuple) else (axes,)):
                n = mesh.size(ax)
                if int(extent) % n != 0:
                    self._fallback(name, "dim %d !%% %s=%d" % (extent, ax, n))
                    return None
                if n > 1:
                    cut.append((dim, ax, n))
        if not cut:
            return None
        if len(cut) > 1:
            raise NotImplementedError(
                "%s: spec %s splits over more than one mesh axis; the port "
                "shards one dim over one axis (ROADMAP A7)" % (name, spec))
        dim, ax, n = cut[0]
        return LocalSlice(dim, ax, mesh.index(ax), int(shape[dim]) // n,
                          shape)


# ---------------------------------------------------------------------------
# training derived names: grads and optimizer state follow their param
# ---------------------------------------------------------------------------
# <param>@GRAD, the backward.py convention
_GRAD_SUFFIX = re.compile(r"@GRAD(?:@RENAME@.*)?$")
# <param>_<kind>_<n>, the Optimizer accumulator kinds; *_pow_acc scalars
# are absent (the scalar guard replicates them)
_ACC_SUFFIX = re.compile(
    r"_(moment[12]?|momentum|velocity|inf_norm|_avg_squared_grad|"
    r"_avg_squared_update|mean_square|mean_grad|squared|linear)"
    r"(_\d+)?$")
# bf16 AMP cast mirrors <var>@RAW_BF16 follow the base var
_CAST_SUFFIX = re.compile(r"@RAW_BF16$")


class TrainPartitionRules(PartitionRules):
    """The training form of a rule table: ``<param>@GRAD``, optimizer
    accumulators ``<param>_<kind>_<n>`` and bf16 cast mirrors
    ``<var>@RAW_BF16`` resolve through their param's rule
    (``beta*_pow_acc`` [1]-scalars hit the scalar guard and replicate).
    ``dp_axis`` names the data-parallel mesh axis."""

    def __init__(self, rules=None, mp_axis="mp", dp_axis="dp"):
        super(TrainPartitionRules, self).__init__(rules, mp_axis=mp_axis)
        self.dp_axis = dp_axis

    @staticmethod
    def base_name(name):
        """Strip the derived-name suffixes down to the param name: grad
        first (a grad of a cast is <x>@RAW_BF16@GRAD), then the cast
        mirror, then ONE accumulator suffix."""
        name = _GRAD_SUFFIX.sub("", name)
        name = _CAST_SUFFIX.sub("", name)
        return _ACC_SUFFIX.sub("", name)

    def match(self, name):
        return super(TrainPartitionRules, self).match(self.base_name(name))


def train_partition_rules_for(family, mp_axis="mp", dp_axis="dp"):
    """The registered family table lifted to training resolution."""
    base = partition_rules_for(family, mp_axis)
    tr = TrainPartitionRules(mp_axis=base.mp_axis, dp_axis=dp_axis)
    tr.rules = list(base.rules)
    return tr


# ---------------------------------------------------------------------------
# per-model-family rule tables
# ---------------------------------------------------------------------------
_FAMILIES = {}


def register_partition_rules(family, factory):
    """Register `factory(mp_axis) -> PartitionRules` for a model family."""
    _FAMILIES[family] = factory
    return factory


def registered_families():
    return sorted(_FAMILIES)


def partition_rules_for(family, mp_axis="mp"):
    """The registered rule table for `family`, bound to `mp_axis`."""
    if family not in _FAMILIES:
        raise KeyError(
            "no partition rules registered for model family %r (known: %s)"
            % (family, ", ".join(registered_families())))
    return _FAMILIES[family](mp_axis)


def _decoder_rules(mp):
    """The shared decoder-block patterns: qkv and ffn-in column-parallel,
    attention-out and ffn-out row-parallel, the vocab projections
    vocab-sharded, the KV slot pool on the heads axis."""
    return [
        # the position table is gathered per position: replicated, and
        # BEFORE the emb.w rule (re.search matches 'emb.w' in 'pos_emb.w')
        (r"pos_emb\.w", P()),
        (r"mha_[qkv]\.w", P(None, mp)),
        (r"mha_o\.w", P(mp, None)),
        (r"ffn_(in|gate|up)\.w", P(None, mp)),
        (r"ffn_in\.b", P(mp)),
        (r"ffn_out\.w", P(mp, None)),
        (r"emb\.w", P(mp, None)),
        (r"softmax_out\.w", P(None, mp)),
        (r"_(k|v)cache_\d+$", P(None, mp, None, None)),
    ]


for _family in ("gpt2", "transformer", "bert"):
    register_partition_rules(
        _family, lambda mp: PartitionRules(_decoder_rules(mp), mp_axis=mp))


# ---------------------------------------------------------------------------
# program stamping + the SPMD lowering context
# ---------------------------------------------------------------------------
def annotate_spmd(program, mesh, rules):
    """Stamp `program` for the executor's SPMD path: persistables are
    held as this rank's slabs per `rules`, and the op lowerings see
    ``current_spmd()`` while it runs.  The program IR is untouched."""
    program._spmd = {"mesh": mesh, "rules": rules}
    return program


_SPMD_STATE = threading.local()


@contextmanager
def spmd_lowering(mesh, rules):
    """Bind (mesh, rules) around a run so op lowerings can take their
    sharded forms; nesting restores the previous binding."""
    prev = getattr(_SPMD_STATE, "ctx", None)
    _SPMD_STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _SPMD_STATE.ctx = prev


def current_spmd():
    """(mesh, rules) inside spmd_lowering, else None."""
    return getattr(_SPMD_STATE, "ctx", None)
