"""User-facing Executor (the counterpart of ``paddle_tpu/executor.py``).

``Executor(place).run(program, feed={...}, fetch_list=[...],
feed_var_name, fetch_var_name, scope, return_numpy, use_program_cache)``
keeps the reference's contract and order.

It compiles first, as the reference does.  One cache entry
(``core/graph.py`` ``StepEntry``) per (program, version, feed signature
as sorted (name, shape, dtype), fetches, scope) holds the step on fixed
buffers: feeds are staged into the entry's buffers, the state the step
reads is the scope's tensors, and updated persistables are copied into
those tensors inside the step.  On the card the first run of a key is
an eager warm-up, the second captures the whole step as a CUDA graph
and replays it, and every later run replays it: the port's counterpart
of the reference's one ``jax.jit`` per key.  On the CPU, which the
caller asks for, an entry runs its step eagerly against the same
buffers.  ``compile_count`` counts entries: captures on the card, plans
on the CPU.  ``run(..., use_program_cache=False)`` runs the step eagerly
through an entry made for that run alone, as Fluid's executor runs
without its program cache.  Every capture of an executor shares one
memory pool, which holds about one step's activations; before any
eager step on the card (a key's warm-up, a run without the program
cache) the executor releases its graphs, and each key's next run
captures again.
``run_loop`` replays one capture K times, ``close`` frees the entries,
their graphs and the pool, ``host_feed_ms`` is the time spent staging feeds
and ``spmd_comm_stats`` what a stamped program's collectives moved.

A program stamped by ``parallel.annotate_spmd`` runs as this rank's
shard of the job (the reference's ``_run_spmd`` runs one program over
the whole mesh): every persistable the rule table shards is held in the
scope as this rank's slab, cut once from the full value at the first
run that reads it; the op lowerings see the mesh through
``spmd_lowering``; and a fetch of a sharded var returns the full value,
gathered over its axis, as the reference's global arrays do.  Ported:
the vocab-sharded projection of ``fused_linear_xent`` on a ``dp`` axis
of size 1.  A ``dp`` axis of size > 1, or a table sharding any other
persistable over an axis of size > 1, raises (ROADMAP A7); an axis of
size 1 shards nothing, so on such a mesh a stamped program runs exactly
as the unstamped one.  A program stamped on a mesh with an axis of size
> 1 runs eagerly, through a cache entry that captures nothing: its gloo
collectives stage through the host and cannot be captured (ROADMAP A4:
capture the segments between them).
"""

import contextlib
import time

import numpy as np
import torch

from . import framework
from .core import scope as scope_mod
from .core.graph import StaleEntry, StepEntry
from .core.registry import fold_seed
from .core.trace import build_plan
from .parallel import collective
from .parallel.partition_rules import spmd_lowering
from .places import default_place
from .profiler import RecordEvent

__all__ = ["Executor", "global_scope", "scope_guard", "gather_persistable"]

global_scope = scope_mod.global_scope
scope_guard = scope_mod.scope_guard

_KIND = {"f": "f", "i": "i", "u": "i", "b": "b"}


def _kind(dtype_str):
    if dtype_str == "bfloat16":
        return "f"
    return _KIND.get(np.dtype(dtype_str).kind, "?")


def as_numpy(value):
    """Fetch result -> numpy; lists and tuples map element by element, as
    the reference's as_numpy does.  numpy has no bfloat16, so a bfloat16
    tensor comes back widened to float32, exactly (the reference hands
    back ml_dtypes' bfloat16 array of the same values)."""
    if isinstance(value, (list, tuple)):
        return [as_numpy(v) for v in value]
    if not isinstance(value, torch.Tensor):
        return value
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.numpy()


def _declared_shape(program, name):
    var = program.global_block()._find_var_recursive(name)
    if var is None or var.shape is None:
        return None
    shape = tuple(int(d) for d in var.shape)
    return shape if all(d >= 0 for d in shape) else None


def _slab_of(program, name):
    """(mesh, LocalSlice) of `name` under the program's stamp, or None
    when the program is unstamped or the var is held whole."""
    spmd = getattr(program, "_spmd", None)
    shape = _declared_shape(program, name)
    if spmd is None or shape is None:
        return None
    mesh, rules = spmd["mesh"], spmd["rules"]
    if rules.match(name)[0] is None:
        return None
    sl = rules.sharding_for(mesh, name, shape)
    return (mesh, sl) if sl is not None else None


def _gather(value, mesh, sl):
    """The full value of a slab (a collective over the slab's axis: every
    rank of it calls this); anything else as it is."""
    if tuple(value.shape) != sl.shape:
        return value
    return collective.all_gather(value, mesh.group(sl.axis), dim=sl.dim)


def gather_persistable(scope, program, name):
    """The full value of persistable `name` of a stamped `program`,
    gathered from the ranks' slabs where the scope holds a slab (every
    rank of the job calls it), else the scope's value."""
    value = scope.find_var(name)
    found = _slab_of(program, name)
    return value if found is None else _gather(value, *found)


def _vocab_projections(block):
    """Names of the weights fed untransposed to fused_linear_xent: the
    only persistables the port holds as vocab slabs.  Under AMP the op's
    W is the bf16 mirror that a ``cast`` writes from the float32 master
    each step; the master is the persistable, so the cast is followed
    back to its X (the cast then runs on the rank's slab)."""
    cast_from = {op.outputs["Out"][0]: op.inputs["X"][0]
                 for op in block.ops if op.type == "cast"}
    return {cast_from.get(w, w) for w in (
        op.inputs["W"][0] for op in block.ops
        if op.type == "fused_linear_xent"
        and not op.attrs.get("transpose_w", False))}


def _spmd_layout(program, plan):
    """The stamped program's slabs among the plan's state, as [(name,
    LocalSlice)], and its fetches' as [(index, LocalSlice)]; raises for
    what the port does not shard yet."""
    spmd = program._spmd
    mesh, rules = spmd["mesh"], spmd["rules"]
    dp_axis = getattr(rules, "dp_axis", None)
    if dp_axis and mesh.size(dp_axis) > 1:
        raise NotImplementedError(
            "a %s axis of size %d (data parallelism: the gradient "
            "all-reduce and the global-batch loss) is not ported yet "
            "(ROADMAP A7)" % (dp_axis, mesh.size(dp_axis)))
    block = program.global_block()
    vocab = _vocab_projections(block)
    base = getattr(rules, "base_name", lambda n: n)
    slabs = []
    for name in plan.state_names:
        var = block._find_var_recursive(name)
        found = _slab_of(program, name) if var is not None and \
            var.persistable else None
        if found is None:
            continue
        sl = found[1]
        if base(name) not in vocab or sl.dim != 1:
            raise NotImplementedError(
                "%s: the rule table splits dim %d over %s = %d; the port "
                "shards only the vocab projection of fused_linear_xent so "
                "far (tensor-parallel trunks, sharded embeddings: ROADMAP "
                "A7)" % (name, sl.dim, sl.axis, mesh.size(sl.axis)))
        slabs.append((name, sl))
    fetches = [(i, found[1]) for i, n in enumerate(plan.fetch_names)
               for found in [_slab_of(program, n)] if found is not None]
    return mesh, rules, slabs, fetches


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        self._entries = {}  # cache key -> StepEntry
        self._step = 0
        self._compiles = 0
        self._host_feed_ms = 0.0
        self._comm = {}  # id(program) -> (program, the last step's log)
        self._stream = None  # the side stream of warm-ups and captures
        self._pool = None  # the memory pool every capture shares
        self._closed = False

    @property
    def compile_count(self):
        """How many steps this executor has compiled: captures on the
        card (a key captured again after its graph was released counts
        again), and the cache entries that capture nothing (the CPU's,
        and those of programs stamped on a mesh that spans ranks).  The
        serving engine's contract reads it: occupancy churn changes feed
        values, never the feed signature, so the pooled step compiles
        once."""
        return self._compiles

    @property
    def host_feed_ms(self):
        """Cumulative milliseconds spent staging feeds onto the device
        (the reference's host_feed_ms counter)."""
        return self._host_feed_ms

    def _check_open(self):
        if self._closed:
            raise RuntimeError("Executor is closed")

    def _check_kind(self, name, dtype, program):
        """The reference's kind-level feed dtype guard (int vs float vs
        bool; widths may differ)."""
        var = program.global_block()._find_var_recursive(name)
        if var is not None and var.dtype:
            want = _kind(var.dtype)
            got = _kind(str(dtype).replace("torch.", ""))
            if want != got:
                raise TypeError(
                    "feed '%s' has dtype %s but the program declares %s — "
                    "cast the feed or fix the data layer dtype"
                    % (name, dtype, var.dtype))

    def _feed_sources(self, feed, program):
        """Each feed as a tensor where it lies (numpy as a host tensor
        over the array, float64 as float32: the reference's f32 policy),
        dtype-guarded.  An entry stages it into its buffer."""
        out = {}
        for name, value in feed.items():
            if not isinstance(value, torch.Tensor):
                arr = np.asarray(value)
                if arr.dtype == np.float64:
                    arr = arr.astype(np.float32)
                value = torch.from_numpy(np.require(arr, requirements="CW"))
            self._check_kind(name, value.dtype, program)
            out[name] = value
        return out

    def _commit_state(self, plan, scope):
        """State that is not yet a tensor on this device (numpy from a
        checkpoint, a tensor from another device) is copied over once
        and written back, so read-only weights are not re-uploaded and
        an in-place update never reaches the caller's array."""
        for n in plan.state_names:
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor):
                if v.device != self.device:
                    scope.set(n, v.to(self.device))
            else:
                scope.set(n, torch.tensor(np.asarray(v), device=self.device))

    @staticmethod
    def _place_slabs(slabs, scope):
        """Replace each sharded persistable that the scope holds whole by
        this rank's slab (narrowed, then contiguous).  A value already
        of the slab's shape was placed by an earlier run."""
        for name, sl in slabs:
            v = scope.find_var(name)
            shape = tuple(v.shape)
            if shape == sl.full_shape:
                scope.set(name, v.narrow(sl.dim, sl.start,
                                         sl.size).contiguous())
            elif shape != sl.shape:
                raise ValueError(
                    "%s: the scope holds %s, neither the whole var %s nor "
                    "this rank's slab %s" % (name, shape, sl.full_shape,
                                             sl.shape))

    def _seed(self, program, step):
        return fold_seed(program.random_seed or 90157, step)

    @staticmethod
    def _fetch_names(fetch_list):
        return [v.name if isinstance(v, framework.Variable) else str(v)
                for v in (fetch_list or [])]

    def _timed_feeds(self, feed, make):
        """make() under the feed_upload span, its time added to
        host_feed_ms when there is any feed."""
        if not feed:
            return make()
        t0 = time.perf_counter()
        with RecordEvent("feed_upload", cat="feed"):
            out = make()
        self._host_feed_ms += (time.perf_counter() - t0) * 1e3
        return out

    def _staged_entry(self, program, feed, fetch_names, scope, cached=True):
        """The key's entry (with `cached` False, a new one that captures
        nothing and is not kept), with this run's feeds staged into it."""
        sources = self._timed_feeds(
            feed, lambda: self._feed_sources(feed, program))
        if cached:
            entry = self._entry(program, sources, fetch_names, scope)
        else:
            entry = self._new_entry(program, sources, fetch_names, scope,
                                    capture=False)
        self._timed_feeds(feed, lambda: entry.stage(sources))
        return entry

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """The reference's signature and order.  feed_var_name and
        fetch_var_name change nothing here: feeds and fetches go by
        name.  With use_program_cache the step runs through its cache
        entry (captured on the card); without, eagerly, op by op,
        through an entry made for this run alone."""
        self._check_open()
        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        fetch_names = self._fetch_names(fetch_list)
        entry = self._staged_entry(program, feed or {}, fetch_names, scope,
                                   cached=use_program_cache)
        seed = self._seed(program, self._step)
        self._step += 1
        with RecordEvent("executor_run"), torch.no_grad():
            _, fetches = self._run_entry(entry, scope, seed)
        return self._out(fetches, return_numpy)

    def _new_entry(self, program, sources, fetch_names, scope, capture):
        plan = build_plan(program, 0, list(sources), fetch_names, scope)
        layout, lowering = None, contextlib.nullcontext
        if getattr(program, "_spmd", None):
            layout = _spmd_layout(program, plan)
            mesh, rules = layout[0], layout[1]
            lowering = lambda: spmd_lowering(mesh, rules)  # noqa: E731
        return StepEntry(program, plan, self.device, lowering,
                         capture=capture and not _spans_ranks(program),
                         spmd=layout)

    def _entry(self, program, sources, fetch_names, scope):
        """The cache entry of this key, made at its first run."""
        sig = tuple(sorted((n, tuple(t.shape), str(t.dtype))
                           for n, t in sources.items()))
        key = (id(program), program._version, sig, tuple(fetch_names),
               id(scope))
        entry = self._entries.get(key)
        if entry is not None and entry.program is program:
            return entry
        entry = self._new_entry(program, sources, fetch_names, scope,
                                capture=True)
        self._entries[key] = entry
        if not entry.captures:
            self._compiles += 1
        return entry

    def _run_entry(self, entry, scope, seed):
        """One step through `entry`: (the entry, the fetches).  A scope whose
        state no longer fits the entry's buffers (a var changed shape or
        dtype) gets a new entry for the key, as a retrace does in the
        reference.  A stamped program's slabs are placed first, its
        collectives recorded, and its sharded fetches gathered."""
        self._commit_state(entry.plan, scope)
        layout = entry.spmd
        if layout is not None:
            self._place_slabs(layout[2], scope)
        if entry.captures and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if entry.captures and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        recording = (collective.recording() if layout is not None
                     else contextlib.nullcontext())
        with recording as comm:
            while True:
                if self.device.type == "cuda" and (not entry.captures
                                                   or entry.runs == 0):
                    self._release_graphs()  # an eager step follows
                graphed = entry.graph is not None
                try:
                    fetches = entry.run(scope, seed, self._stream,
                                        self._pool)
                    break
                except StaleEntry:
                    entry = self._renew(entry)
            if entry.captures and not graphed and entry.graph is not None:
                self._compiles += 1
            if layout is not None:
                mesh, fetch_slabs = layout[0], layout[3]
                fetches = list(fetches)
                for i, sl in fetch_slabs:
                    fetches[i] = _gather(fetches[i], mesh, sl)
        if layout is not None:
            self._comm[id(entry.program)] = (entry.program, comm)
        return entry, fetches

    def _renew(self, entry):
        key = next(k for k, e in self._entries.items() if e is entry)
        fresh = StepEntry(entry.program, entry.plan, self.device,
                          entry.lowering, capture=entry.captures,
                          spmd=entry.spmd)
        fresh.stage(entry.feeds)
        entry.close()
        self._entries[key] = fresh
        if not fresh.captures:
            self._compiles += 1
        return fresh

    def _release_graphs(self):
        """Free every captured graph and the executor's pool (no replay
        in flight); each entry's next run captures again.  Called before
        every eager step on the card (a key's warm-up, a run without the
        program cache, a step that captures nothing): the pool holds a
        step's activations, and an eager step beside it may not fit."""
        held = [e for e in self._entries.values() if e.graph is not None]
        if not held:
            return
        torch.cuda.synchronize(self.device)
        for entry in held:
            entry.release()
        self._pool = None
        torch.cuda.empty_cache()

    @staticmethod
    def _out(fetches, return_numpy):
        """Fetches as copies: a later run overwrites the entry's
        buffers (and, on the card, a replay the captured step's own, or
        those of another graph of the executor's pool)."""
        if return_numpy:
            return [as_numpy(t.clone() if t.device.type == "cpu" else t)
                    for t in fetches]
        return [t.clone() for t in fetches]

    def run_loop(self, iters, program=None, feed=None, fetch_list=None,
                 scope=None, return_numpy=True):
        """Run `iters` steps of `program` with constant feeds, as one
        replay loop of its captured step: the feeds are staged once, and
        step i reseeds the draws with the step counter step0 + i, so the
        fetches and the scope's state equal `iters` sequential run()
        calls bit for bit.  Returns the last step's fetches.  Refuses
        what the reference refuses: programs with host-boundary ops, and
        programs whose collectives cannot be captured (a stamped mesh
        that spans ranks)."""
        iters = int(iters)
        if iters <= 0:
            raise ValueError("run_loop: iters must be positive")
        self._check_open()
        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        if any(op.type in ("listen_and_serv", "read")
               for op in program.global_block().ops):
            raise ValueError(
                "run_loop cannot iterate programs with host-boundary ops "
                "(py_reader 'read' / listen_and_serv) — their IO happens "
                "at the executor boundary, outside the captured loop")
        if _spans_ranks(program):
            raise ValueError(
                "run_loop does not drive a program stamped on a mesh that "
                "spans ranks (its gloo collectives stage through the host "
                "and cannot be captured); call run() per step")
        fetch_names = self._fetch_names(fetch_list)
        entry = self._staged_entry(program, feed or {}, fetch_names, scope)
        with RecordEvent("executor_run_loop"), torch.no_grad():
            for _ in range(iters):
                seed = self._seed(program, self._step)
                self._step += 1
                entry, fetches = self._run_entry(entry, scope, seed)
        return self._out(fetches, return_numpy)

    def spmd_comm_stats(self, program):
        """What the collectives of `program`'s last step moved on this
        rank, as the reference reports its compiled step's:
        {"per_op": {kind: {"count", "bytes"}}, "total_bytes"}, the kinds
        "all-reduce", "all-gather" and "broadcast", the bytes those of
        each result.  Empty for a program that issued none (unstamped,
        or on a mesh of one rank)."""
        per_op, total = {}, 0
        found = self._comm.get(id(program))
        for kind, nbytes in (found[1] if found and found[0] is program
                             else ()):
            ent = per_op.setdefault(kind, {"count": 0, "bytes": 0})
            ent["count"] += 1
            ent["bytes"] += nbytes
            total += nbytes
        return {"per_op": per_op, "total_bytes": total}

    def close(self):
        """Free every cache entry with its graph, and the memory pool;
        later run() and run_loop() calls raise, as in the reference."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no replay in flight
        for entry in self._entries.values():
            entry.close()
        self._entries.clear()
        self._pool = None
        self._comm.clear()
        self._closed = True
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _spans_ranks(program):
    """Whether `program` is stamped on a mesh with an axis of more than
    one rank: its collectives then run, and it runs eagerly."""
    spmd = getattr(program, "_spmd", None)
    if not spmd:
        return False
    mesh = spmd["mesh"]
    return any(mesh.size(a) > 1 for a in mesh.axis_names)
