"""Compile-first step cache (the counterpart of the reference's
``ExecutionCache`` and ``CompiledBlock``, ``paddle_tpu/core/trace.py``).

The reference jits one XLA function per (program, version, feed
signature, fetches, scope) and donates its read-write state.  The
port's counterpart of ``jax.jit`` is a CUDA graph: a ``StepEntry``
holds one such key's step on fixed buffers, and on the card it captures
the step once and replays it after that.

- **Feeds** are staged into static buffers of the entry (``stage``).
- **State.** The tensors the scope holds for the state the step reads
  are the entry's (``bind``).  An updated var is copied (``copy_``) into
  the tensor the scope holds for it, inside the step, so the scope's
  tensors stay the graph's.  A var whose tensor the scope no longer
  holds (a user's ``scope.set``, a checkpoint load) has its value
  copied in before the next run: a replay never reads a stale address.
  A var whose shape or dtype changed makes the entry stale, and the
  executor builds a new one.  No two vars share a tensor, so an update
  in place reaches no other var: an updated var whose tensor another
  scope var also holds gets a copy of its own before the entry fixes
  its buffers, and a step that leaves one value under two names gives
  the second a copy.
- **Random draws** come from the entry's ``DrawSites``: one generator a
  draw, registered with the graph and reseeded on the host before each
  replay with the fold the eager runner uses, so the captured masks
  equal the eager ones.
- **Constants** the lowerings make from host data
  (``LowerCtx.constant``) are made at the first run and kept.
- **On the card** the first run is an eager warm-up on the executor's
  side stream (it builds the kernel library, the cuBLAS handles and the
  allocator's blocks, and makes the tensors of the vars the step
  creates); the second captures the step on that stream and replays
  it; later runs replay.  The kernel wrappers count launches in Python,
  which a replay does not run: the launches recorded during the capture
  are added to the counts at each replay instead.  A failed capture or
  replay raises; nothing retries eagerly.
- **One memory pool an executor.**  Every entry of an executor captures
  into the executor's pool, so the pool holds about one step's
  activations however many keys are captured.  A capture may place its
  tensors where an earlier capture's intermediates lay.  That is safe
  because replays are issued in order on one stream, never two at once,
  and nothing a graph leaves in the pool is read after another graph's
  replay: updated state is copied into tensors made outside the pool
  (the scope's, or the warm-up's), the fetches are copied out before
  the executor issues its next replay (``Executor._out``), and a
  capture that would leave a new tensor in the pool (a var or a
  constant the warm-up did not make) raises.  No eager step runs beside
  the pool: before a key's warm-up or a run that captures nothing the
  executor frees every graph (``release``), and each key's next run
  captures again.
- **On the CPU**, which the caller asked for, and for an entry made not
  to capture (an eager run, a program whose collectives cannot be
  captured), every run is the eager step against the same buffers.
"""

import gc

import torch

from ..kernels import KERNELS
from .registry import DrawSites, LowerCtx
from .trace import run_step

__all__ = ["StepEntry", "StaleEntry"]


class StaleEntry(Exception):
    """The scope's state no longer fits the entry's buffers."""


def _fits(t, like):
    return (isinstance(t, torch.Tensor) and t.device == like.device
            and t.dtype == like.dtype and t.shape == like.shape)


def _storage(t):
    """Where `t`'s memory lies: equal for two tensors that share it."""
    return (t.device, t.untyped_storage().data_ptr())


def _same_view(a, b):
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


class StepEntry:
    """One cache key's step on fixed buffers.  `lowering` makes the
    context the step's lowerings run under (the mesh of a stamped
    program, else a null context); `capture` False keeps the step eager
    on the card too; `spmd` is the executor's own record of a stamped
    program's slabs, kept here unread."""

    def __init__(self, program, plan, device, lowering, capture=True,
                 spmd=None):
        self.program = program
        self.plan = plan
        self.device = device
        self.lowering = lowering
        self.captures = capture and device.type == "cuda"
        self.spmd = spmd
        self.feeds = {}    # name -> static buffer
        self.state = {}    # name -> the tensor the step reads
        self.targets = {}  # updated name -> the tensor the step writes
        self.draws = DrawSites(device)
        self.consts = {}
        self.runs = 0
        self.frozen = False  # buffers fixed: copied into, never replaced
        self.graph = None
        self.fetch_out = None  # the captured step's fetch tensors
        self.rebind = ()  # (name, tensor) the scope holds after a replay
        self.deltas = ()  # (wrapper, launches) of one captured step

    # ---- buffers ------------------------------------------------------
    def stage(self, feeds):
        """Copy each feed (a tensor on any device) into its buffer."""
        for n, src in feeds.items():
            buf = self.feeds.get(n)
            if buf is None:
                buf = self.feeds[n] = torch.empty(
                    src.shape, dtype=src.dtype, device=self.device)
            buf.copy_(src)

    def bind(self, scope):
        """Point the step's state at the scope's tensors.  Before the
        buffers are fixed the entry takes what the scope holds (each
        updated var's tensor its own); after, a value the scope holds in
        another tensor is copied in and the scope is pointed back at the
        entry's tensor."""
        if not self.frozen:
            self._own_updated(scope)
        for n in self.plan.state_names:
            v = scope.find_var(n)
            t = self.state.get(n)
            if t is v:
                continue
            if t is None or not self.frozen:
                self.state[n] = v
                continue
            if not _fits(v, t):
                raise StaleEntry(n)
            t.copy_(v)
            scope.set(n, t)

    def _own_updated(self, scope):
        """Give each var the step updates in place a tensor that no other
        scope var holds (a copy where one does: a startup's ``assign``
        leaves two names on one tensor), so the update reaches that var
        alone, as the reference's fresh arrays do."""
        holders = {}
        for n, v in scope.visible_vars():
            if isinstance(v, torch.Tensor) and v.numel():
                holders.setdefault(_storage(v), set()).add(n)
        for n in self.plan.updated:
            v = scope.find_var(n)
            if not isinstance(v, torch.Tensor) or not v.numel():
                continue
            names = holders[_storage(v)]
            if names != {n}:
                names.discard(n)
                scope.set(n, v.clone())

    def _commit(self, scope, updated, capturing=False):
        """Write the step's updated vars into their tensors: in place
        where the var has a tensor of its shape and dtype, else the value
        becomes the var's tensor (never during a capture: it would lie in
        the pool).  A value that shares memory with any buffer of the
        entry, or with another var's new tensor, is copied first, so no
        write reads what an earlier write of this commit changed, and no
        var's tensor is another var's or a feed's buffer."""
        held = {_storage(t) for t in self.feeds.values()}
        held.update(_storage(t) for t in self.state.values())
        held.update(_storage(t) for t in self.targets.values())
        held.update(_storage(t) for t in self.consts.values())
        writes = []
        for n, v in updated.items():
            t = self.state.get(n)
            if t is None:
                t = self.targets.get(n)
            if t is None:
                cur = scope.find_var(n)
                if _fits(cur, v):
                    t = cur
            if t is not None and not _fits(v, t):
                t = None  # the var changes shape or dtype: v is its tensor
            if t is not None and _same_view(v, t):
                writes.append((n, t, None))
                continue
            if t is None and capturing:
                raise RuntimeError(
                    "%s: the captured step makes a tensor for this var that "
                    "its warm-up did not (a shape or dtype that changed "
                    "between runs of one key)" % n)
            if _storage(v) in held:
                v = v.clone()
            if t is None:
                held.add(_storage(v))  # n's new tensor: no other var's
            writes.append((n, t, v))
        pairs = []
        for n, t, v in writes:
            if t is None:
                t = v
            elif v is not None:
                t.copy_(v)
            self.targets[n] = t
            pairs.append((n, t))
        return pairs

    @staticmethod
    def _point(scope, pairs):
        for n, t in pairs:
            if scope.find_var(n) is not t:
                scope.set(n, t)

    # ---- running ------------------------------------------------------
    def _eager(self, scope, seed):
        ctx = LowerCtx(seed=seed, device=self.device, draws=self.draws,
                       consts=self.consts)
        with self.lowering():
            fetches, updated = run_step(self.program, self.plan, self.feeds,
                                        self.state, ctx)
        self._point(scope, self._commit(scope, updated))
        return fetches

    def run(self, scope, seed, stream=None, pool=None):
        """One step at `seed`: eager on the CPU or without capture; on
        the card a warm-up on `stream` at the first run, the capture into
        `pool` at the second, a replay after.  Returns the fetched
        tensors (the captured step's own buffers on a replay: copy them
        before the next replay)."""
        self.bind(scope)
        self.runs += 1
        if not self.captures:
            fetches = self._eager(scope, seed)
            self.frozen = True
            return fetches
        if self.runs == 1:
            return self._warm_up(scope, seed, stream)
        if self.graph is None:
            self._capture(scope, seed, stream, pool)
        return self.replay(scope, seed)

    def _warm_up(self, scope, seed, stream):
        cur = torch.cuda.current_stream()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            fetches = self._eager(scope, seed)
        cur.wait_stream(stream)
        # what the warm-up made on the side stream and the scope or the
        # caller keeps is used on this stream from now on
        for t in list(fetches) + list(self.targets.values()):
            if t.device.type == "cuda":
                t.record_stream(cur)
        return fetches

    def _capture(self, scope, seed, stream, pool):
        """Capture the step into `pool`.  The garbage collector runs
        first and is off during the capture: a finalizer that frees CUDA
        memory or a graph (an unreachable executor's, say) is an
        operation a capturing stream does not permit, and it would
        invalidate the capture."""
        self.frozen = True
        graph = torch.cuda.CUDAGraph()
        for g in self.draws.gens:
            graph.register_generator_state(g)
        before = [fn.launches for fn in KERNELS]
        ctx = LowerCtx(seed=seed, device=self.device, draws=self.draws,
                       consts=self.consts)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        self.draws.capturing = True
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream), \
                    self.lowering():
                fetches, updated = run_step(self.program, self.plan,
                                            self.feeds, self.state, ctx)
                pairs = self._commit(scope, updated, capturing=True)
        finally:
            if collecting:
                gc.enable()
            self.draws.capturing = False
            captured = [fn.launches for fn in KERNELS]
            for fn, n in zip(KERNELS, before):
                fn.launches = n  # the capture launched nothing
        self.deltas = tuple((fn, b - a) for fn, a, b in
                            zip(KERNELS, before, captured) if b != a)
        self.graph = graph
        self.fetch_out = fetches
        self.rebind = pairs

    def replay(self, scope, seed):
        """Replay the captured step at `seed` (the state bound first)."""
        self.draws.reseed(seed)
        self.graph.replay()
        for fn, n in self.deltas:
            fn.launches += n
        self._point(scope, self.rebind)
        return self.fetch_out

    def release(self):
        """Free the captured graph (its memory returns to the pool); the
        next run captures the step again."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.fetch_out = None
        self.rebind = self.deltas = ()

    def close(self):
        """Free the graph and the buffers."""
        self.release()
        self.feeds, self.state, self.targets, self.consts = {}, {}, {}, {}
