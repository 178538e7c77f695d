"""Serving fabric: a sticky multi-pool router over N ServingEngines (the
counterpart of ``paddle_tpu/serving/router.py``, its in-process pools).

ONE FabricRouter owns the admission queue and places each incoming
Request onto exactly one pool (sticky slot placement): the placement
score orders LIVE pools by (occupancy, engine backlog, remaining work,
t_max, pid) and a request only leaves its pool through failover.  Every
pool is a whole ServingEngine in its OWN Scope (the KV-cache
persistable names are fixed per model family, so pools sharing a scope
would alias their slot pools) with its own Executor; the router wraps
every engine call in scope_guard(pool.scope).  Pools advance in
LOCKSTEP, one after another on the calling thread: one fabric step
steps every serving pool once, so the fabric clock, every engine's
`now` and Request.arrival share one virtual time axis.

Degradation contract (tests/test_torch_fabric.py):

* Backpressure: an arrival that finds `queue_depth` requests already
  waiting (no pool could take them) is rejected loudly with a terminal
  REJECTED_QUEUE_FULL at the router.  Never a hang, never an unbounded
  queue.
* Drain-and-retire: pool removal stops new placements, lets in-flight
  requests finish, and only then retires the pool: no orphaned slots.
* Failover: a pool that misses `miss_beats` health beats (its step
  loop was killed: the `pool_kill` fault action) or whose step raises
  is declared dead; its queued requests re-enter the router queue as
  they are and each in-flight request is RE-PLACED as a replay: prompt
  + the emitted tokens become the new prompt, the budget shrinks by
  them, and sample_step_base moves the sampling keys past them, so the
  re-decoded stream continues the solo run's tokens exactly.
  Survivors see only feed-value changes: no new capture.
* Cross-pool placement: a request goes only to pools whose t_max fits
  len(prompt) + max_new; one that fits no pool raises at submit, and
  one whose only fitting pool died while it waited ends
  REJECTED_NO_FIT.

Two rules of the port's own:

* No failover hides the device.  A pool's step that raises an error of
  the device (kernels/build.py's KernelError: a kernel that did not
  build, load or launch, or a kernel's wrapper refusing its inputs --
  dtype, device, contiguity, shape, alignment, extent -- as
  KernelInputError / KernelTypeError; or an error of torch's CUDA
  runtime; found anywhere in the exception's chain) ends the run: it
  propagates out of step().  Every other error fails the pool over, as in the reference.
* A gone pool is released.  Once a dead or retired pool is harvested
  and dropped, its executor is closed (its captured graphs, their
  memory pool and the scope's KV caches' last users go with it; the
  executor's compile_count stays readable).

Process pools (`pool_mode="process"`, ProcessPool, attach_worker,
control_service, serve_control) wait for the RPC transport: ROADMAP
A5.4b, after A8.
"""

import re
import threading
import time

import numpy as np
import torch

from ..core.scope import scope_guard
from ..kernels.build import KernelError

__all__ = ["FabricRouter", "ProcessPool", "parse_pool_schedule"]

_NOT_PORTED = "ROADMAP A5.4b, after A8's RPC transport"

# what torch's CUDA runtime says when a launch, a copy, a library call or
# an allocation fails on the card
_CUDA_MESSAGE = re.compile(
    r"CUDA error|CUDA out of memory|CUBLAS_STATUS|CUDNN_STATUS|cuDNN error|"
    r"device-side assert|an illegal memory access")


def _device_error(exc):
    """Whether `exc`, or an exception in its chain, comes from the card:
    a kernel that did not build, load or launch or that refused its
    inputs, or torch's CUDA runtime."""
    kinds = tuple(k for k in (
        getattr(torch, "AcceleratorError", None),
        getattr(torch.cuda, "CudaError", None),
        getattr(torch.cuda, "OutOfMemoryError", None),
        getattr(torch.cuda, "DeferredCudaCallError", None)) if k is not None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (KernelError,) + kinds):
            return True
        if isinstance(exc, RuntimeError) and _CUDA_MESSAGE.search(str(exc)):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def parse_pool_schedule(spec):
    """'T:+N,T:-N' -> [(T, delta)] sorted by T.  T is in fabric STEPS
    for FabricRouter.run."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if part:
            t_s, _, d = part.partition(":")
            out.append((float(t_s), int(d)))
    out.sort(key=lambda e: e[0])
    return out


class _PoolHandle:
    """One serving pool: engine + its private scope + health state."""

    __slots__ = ("pid", "engine", "scope", "state", "killed",
                 "missed_beats")

    def __init__(self, pid, engine, scope):
        self.pid = int(pid)
        self.engine = engine
        self.scope = scope
        self.state = "live"  # live | draining | dead | retired
        self.killed = False  # SIGKILL-equivalent: step loop stops beating
        self.missed_beats = 0


class _ProcessPoolPart:
    """A part of the process-pool backend: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "%s: process pools are not ported yet (%s)"
            % (type(self).__name__, _NOT_PORTED))


class _WireSlot(_ProcessPoolPart):
    """Router-side mirror of one active worker slot (ROADMAP A5.4b)."""


class _MirrorPool(_ProcessPoolPart):
    """The SlotPool surface rebuilt from a worker's replies (ROADMAP
    A5.4b)."""


class _ExeStats(_ProcessPoolPart):
    """A worker's compile_count in router stats (ROADMAP A5.4b)."""


class ProcessPool(_ProcessPoolPart):
    """One out-of-process pool driven over RPC (ROADMAP A5.4b)."""


class FabricRouter:
    """pool_factory() -> (engine, scope): builds a ServingEngine whose
    scope already holds the model weights.  Every pool must hold
    IDENTICAL weights (the same startup seed, or tensors copied from one
    source scope): failover replays a prefix into a survivor, and a
    bit-exact continuation needs the same model on both sides.
    `pool_mode` and `rpc_policy` take the reference's places; process
    pools (pool_mode="process") and an RPC policy raise until ROADMAP
    A5.4b."""

    def __init__(self, pool_factory, n_pools=1, queue_depth=None,
                 miss_beats=2, fault_schedule=None, max_pools=8,
                 pool_mode="inproc", rpc_policy=None):
        if pool_mode == "process":
            raise NotImplementedError(
                "FabricRouter: pool_mode=\"process\" (pools in worker "
                "processes over RPC) is not ported yet (%s)" % _NOT_PORTED)
        if rpc_policy is not None:
            raise NotImplementedError(
                "FabricRouter: rpc_policy (the RPC transport's retries and "
                "deadlines) has no in-process use and is not ported yet (%s)"
                % _NOT_PORTED)
        assert pool_mode == "inproc", pool_mode
        assert int(n_pools) >= 1, n_pools
        self.pool_factory = pool_factory
        self.queue_depth = None if queue_depth is None else int(queue_depth)
        assert self.queue_depth is None or self.queue_depth >= 0
        self.miss_beats = max(1, int(miss_beats))
        self.faults = fault_schedule
        self.max_pools = int(max_pools)
        self.pools = {}  # pid -> _PoolHandle (dead/retired pruned)
        self.queue = []  # router admission queue (arrival, rid) order
        self.now = 0
        self._next_pid = 0
        self._step_wall = []  # shared with every engine (latency base)
        self._results = {}
        self._prefix = {}  # rid -> emitted tokens carried over failovers
        # the token arrays registered through register_prefix: pools that
        # join later (scale-up) get every one replayed into their cache
        self._prefixes = []
        self._pending_scale = []  # deltas queued by request_scale
        self._lock = threading.RLock()
        self.counters = {"submitted": 0, "finished": 0, "rejected": 0,
                         "expired": 0, "replaced": 0, "pool_kills": 0,
                         "pools_added": 0, "pools_retired": 0,
                         "pools_died": 0}
        for _ in range(int(n_pools)):
            self.add_pool()

    # ---- pool membership -----------------------------------------------
    def add_pool(self):
        """Grow one pool: build it in its own scope and zero its caches,
        the draft's too on a speculative engine (the reference zeroes only
        the target's, and its speculative pools die at their first
        draft dispatch).  The pool's clock fast-forwards onto the
        fabric's step axis (a pool joining at step T admits arrivals <= T
        at once)."""
        with self._lock:
            if len(self._routable()) >= self.max_pools:
                raise RuntimeError(
                    "fabric at max_pools=%d" % self.max_pools)
            engine, scope = self.pool_factory()
            with scope_guard(scope):
                engine.exe.run(engine.cache_startup)
                if engine.spec_k:
                    engine.exe.run(engine.draft_startup,
                                   scope=engine.draft_scope)
            return self._register_pool(engine, scope)

    def attach_worker(self, endpoint, proc=None):
        """Adopt a running pool worker process (ROADMAP A5.4b)."""
        raise NotImplementedError(
            "FabricRouter.attach_worker: process pools are not ported yet "
            "(%s)" % _NOT_PORTED)

    def _register_pool(self, engine, scope):
        pid = self._next_pid
        self._next_pid += 1
        engine.now = self.now
        engine._step_wall = self._step_wall  # one latency clock
        self.pools[pid] = _PoolHandle(pid, engine, scope)
        self.counters["pools_added"] += 1
        print("FABRIC POOL ADD pid=%d step=%d" % (pid, self.now), flush=True)
        # a pool joining after registration (scale-up) must serve
        # prefix-hit traffic as the pools present at registration do
        for toks in self._prefixes:
            self._register_prefix_on(self.pools[pid], toks)
        return pid

    def _release(self, h):
        """Close a gone pool's executor (its graphs, their memory pool and
        its cache entries) unless a pool still routed shares it.  An
        engine whose executor is already gone (None) is left alone."""
        exe = getattr(h.engine, "exe", None)
        if exe is not None and all(p.engine.exe is not exe
                                   for p in self.pools.values()):
            exe.close()

    # ---- prefix-cache registration -------------------------------------
    def _register_prefix_on(self, h, tokens):
        """Register `tokens` on one pool (skipped when the pool carries
        no prefix cache).  Returns the pool's prefix row id or None."""
        if getattr(h.engine, "prefix", None) is None:
            return None
        with scope_guard(h.scope):
            return h.engine.register_prefix(tokens)

    def register_prefix(self, tokens):
        """Register one common prompt prefix FABRIC-wide: every routable
        pool with a prefix cache prefills and stores it, and the router
        records the tokens so that pools joining later get it replayed.
        Pools without a prefix cache are skipped (cold prefill there,
        never a wrong stream).  Call while the fabric is idle (engines
        refuse registration with slots busy).  Returns {pid: row} for the
        pools that took it."""
        tokens = np.asarray(tokens, "int64").reshape(-1)
        with self._lock:
            rows = {}
            for h in self._routable():
                row = self._register_prefix_on(h, tokens)
                if row is not None:
                    rows[h.pid] = row
            self._prefixes.append(tokens.copy())
            return rows

    def _prefix_match_len(self, h, req):
        """Expected prefix-cache reuse for `req` on pool `h` in tokens (0:
        no prefix cache or no match), from the engine's own host index
        (match() counts no hit or miss)."""
        pfx = getattr(h.engine, "prefix", None)
        return 0 if pfx is None else int(pfx.match(req.prompt)[1])

    def drain_pool(self, pid):
        """Begin drain-and-retire: no new placements; in-flight requests
        finish on their slots; the empty pool retires at a later step()."""
        with self._lock:
            h = self.pools[pid]
            if h.state == "live":
                h.state = "draining"
                print("FABRIC POOL DRAIN pid=%d step=%d"
                      % (pid, self.now), flush=True)

    def kill_pool(self, pid):
        """SIGKILL-equivalent: the pool's step loop stops responding (no
        beats, no steps).  Death is DECLARED by the health check after
        miss_beats missed beats: the failover path under test."""
        with self._lock:
            h = self.pools[pid]
            h.killed = True
            self.counters["pool_kills"] += 1
            print("FABRIC POOL KILL pid=%d step=%d" % (pid, self.now),
                  flush=True)

    def proc_kill_pool(self, pid):
        """The `pool_proc_kill` fault action: a process pool's worker
        would take a real SIGKILL (ROADMAP A5.4b); an in-process pool
        falls back to the cooperative kill, as in the reference."""
        with self._lock:
            print("FABRIC POOL PROC-KILL pid=%d step=%d: in-process pool, "
                  "falling back to cooperative kill" % (pid, self.now),
                  flush=True)
            return self.kill_pool(pid)

    def report_worker_death(self, pid=None, endpoint=None):
        """A death report: the named pool is declared dead at the NEXT
        step.  `endpoint` names a process pool's worker (ROADMAP A5.4b):
        no in-process pool has one."""
        with self._lock:
            for h in list(self.pools.values()):
                if h.pid == pid:
                    h.killed = True
                    h.missed_beats = self.miss_beats
                    print("FABRIC POOL DEATH-REPORTED pid=%d step=%d"
                          % (h.pid, self.now), flush=True)
                    return True
            return False

    def _routable(self):
        return [h for h in self.pools.values()
                if h.state in ("live", "draining")]

    def _live(self):
        return [h for h in self.pools.values() if h.state == "live"]

    def scale_pools(self, delta):
        """Apply a pool-count delta NOW: +N adds pools, -N drains the
        newest live pools (drain-and-retire, never a kill)."""
        delta = int(delta)
        for _ in range(max(0, delta)):
            if len(self._routable()) < self.max_pools:
                self.add_pool()
        if delta < 0:
            victims = sorted(self._live(), key=lambda h: -h.pid)
            keep_min = 1  # never drain the last live pool
            n = min(-delta, max(0, len(self._live()) - keep_min))
            for h in victims[:n]:
                self.drain_pool(h.pid)

    def request_scale(self, delta):
        """Thread-safe scale request: queued and applied at the next
        fabric step boundary."""
        with self._lock:
            self._pending_scale.append(int(delta))

    # ---- request intake ------------------------------------------------
    def submit(self, req):
        with self._lock:
            live = {q.rid for q in self.queue}
            for h in self._routable():
                live.update(q.rid for q in h.engine.queue)
                live.update(s.req.rid
                            for _, s in h.engine.pool.active_slots())
            if req.rid in live:
                raise ValueError("duplicate request id %r" % (req.rid,))
            # pools of different sizes coexist: the request must fit SOME
            # routable pool (placement keys long requests to big pools);
            # reject with the reason, never truncate
            routable = self._routable()
            if not any(h.engine.pool.fits(req) for h in routable):
                cap = max((h.engine.pool.t_max for h in routable),
                          default=0)
                raise ValueError(
                    "request %r exceeds every pool's capacity: prompt "
                    "%d + new %d > largest t_max %d + 1 — no pool fits"
                    % (req.rid, req.prompt.size, req.max_new_tokens,
                       cap))
            self.queue.append(req)
            self.queue.sort(key=lambda r: (r.arrival, r.rid))
            self.counters["submitted"] += 1

    # ---- terminal bookkeeping ------------------------------------------
    def _terminal(self, req, status):
        """Router-side terminal record, same shape as engine results."""
        self.counters["rejected" if status.startswith("REJECTED")
                      else "expired"] += 1
        print("FABRIC %s rid=%r step=%d" % (status, req.rid, self.now),
              flush=True)
        wall = time.time()
        a = min(req.arrival_step, max(0, len(self._step_wall) - 1))
        self._results[req.rid] = {
            "tokens": np.asarray(self._prefix.get(req.rid, []), "int64"),
            "prompt_len": int(req.prompt.size),
            "arrival_step": req.arrival_step,
            "admit_step": None,
            "finish_step": self.now,
            "status": status,
            "latency_steps": self.now - req.arrival_step + 1,
            "latency_s": wall - (self._step_wall[a] if self._step_wall
                                 else wall),
        }

    def _harvest(self, h, rids):
        """Pull terminal results out of a pool's engine, stitching the
        failover prefix back onto replayed streams."""
        for rid in rids:
            r = dict(h.engine._results[rid])
            pref = self._prefix.pop(rid, None)
            if pref is not None:
                r["tokens"] = np.concatenate(
                    [np.asarray(pref, "int64"),
                     np.asarray(r["tokens"], "int64")])
                r["replayed"] = True
            if r["status"] == "OK":
                self.counters["finished"] += 1
            else:
                self.counters["rejected" if r["status"].startswith(
                    "REJECTED") else "expired"] += 1
            r["pool"] = h.pid
            self._results[rid] = r

    # ---- failover ------------------------------------------------------
    def _declare_dead(self, h):
        """Harvest a dead pool's queued AND in-flight requests and
        re-place them: queued ones re-enter the router queue as they are;
        each in-flight one replays prompt + emitted prefix (original
        arrival kept, so its deadline budget and queue priority are
        unchanged).  Then release the pool."""
        from .trace import Request

        h.state = "dead"
        self.counters["pools_died"] += 1
        n_q, n_f = len(h.engine.queue), len(h.engine.pool.active_slots())
        print("FABRIC POOL DEAD pid=%d step=%d requeue=%d replay=%d"
              % (h.pid, self.now, n_q, n_f), flush=True)
        for req in h.engine.queue:
            self.queue.append(req)
        for slot, s in h.engine.pool.active_slots():
            req = s.req
            prior = list(self._prefix.get(req.rid, []))
            prefix = prior + [int(t) for t in s.out]
            self._prefix[req.rid] = prefix
            emitted = len(s.out)
            replay = Request(
                rid=req.rid,
                prompt=np.concatenate(
                    [req.prompt, np.asarray(s.out, "int64")])
                if emitted else req.prompt,
                max_new_tokens=req.max_new_tokens - emitted,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, seed=req.seed, eos_id=req.eos_id,
                arrival=req.arrival, deadline=req.deadline,
                sample_step_base=req.sample_step_base + emitted)
            self.queue.append(replay)
            self.counters["replaced"] += 1
            h.engine.pool.evict(slot)
        h.engine.queue = []
        self.queue.sort(key=lambda r: (r.arrival, r.rid))
        self.pools.pop(h.pid, None)
        self._release(h)

    # ---- placement -----------------------------------------------------
    def _score(self, h, req):
        """Placement score (lower is better): only live pools are scored;
        then occupancy, the pool's own backlog, the request's REMAINING
        WORK on this pool ((prompt - prefix match) + max_new, so template
        traffic stays on the pools holding its prefix), capacity
        (best-fit: a short request prefers the smallest fitting pool,
        keeping big pools for what only they hold), then pid."""
        active = len(h.engine.pool.active_slots())
        occ = active / float(h.engine.n_slots)
        est_work = (int(req.prompt.size) - self._prefix_match_len(h, req)
                    + int(req.max_new_tokens))
        return (occ, len(h.engine.queue), est_work,
                h.engine.pool.t_max, h.pid)

    def _place(self):
        """Route due arrivals onto pools; reject past the fabric-wide
        queue depth.  A routed request goes straight into its pool's
        engine queue against a KNOWN free slot, so pools never build
        private backlogs: the router's queue IS the fabric queue.  A
        request no LIVE pool can hold (the big pool died or drained since
        submit) ends REJECTED_NO_FIT."""
        still, waiting = [], 0
        free = {h.pid: len(h.engine.pool.free_slots())
                for h in self._live()}
        for req in self.queue:
            if req.arrival > self.now:
                still.append(req)
                continue
            d = req.deadline
            if d is not None and self.now >= req.arrival_step + d:
                self._terminal(req, "DEADLINE_EXPIRED")
                continue
            fitting = [h for h in self._live()
                       if h.engine.pool.fits(req)]
            if not fitting:
                self._terminal(req, "REJECTED_NO_FIT")
                continue
            target = None
            for h in sorted(fitting,
                            key=lambda h: self._score(h, req)):
                if free.get(h.pid, 0) > 0:
                    target = h
                    break
            if target is not None:
                free[target.pid] -= 1
                target.engine.submit(req)
            elif self.queue_depth is None or waiting < self.queue_depth:
                waiting += 1
                still.append(req)
            else:
                self._terminal(req, "REJECTED_QUEUE_FULL")
        self.queue = still

    # ---- one fabric step -----------------------------------------------
    def step(self):
        """Health beats -> failover -> placement -> lockstep pool steps
        -> drain retirement.  Returns the rids that reached a terminal
        state this fabric step.  A device error inside a pool's step
        propagates (see the module docstring)."""
        with self._lock:
            self._step_wall.append(time.time())
            for delta in self._pending_scale:
                self.scale_pools(delta)
            self._pending_scale = []
            self._maybe_inject_fault()
            terminal = []
            # health: a killed step loop stops beating; declare death
            # after miss_beats consecutive silent fabric steps
            for h in list(self._routable()):
                if h.killed:
                    h.missed_beats += 1
                    if h.missed_beats >= self.miss_beats:
                        self._declare_dead(h)
            self._place()
            for h in list(self._routable()):
                if h.killed:
                    continue
                try:
                    with scope_guard(h.scope):
                        done = h.engine.step()
                except Exception as e:  # dead step thread: fail over NOW
                    if _device_error(e):
                        raise
                    print("FABRIC POOL STEP DIED pid=%d step=%d: %r"
                          % (h.pid, self.now, e), flush=True)
                    self._declare_dead(h)
                    continue
                h.missed_beats = 0
                if done:
                    self._harvest(h, done)
                    terminal.extend(done)
                if (h.state == "draining" and not h.engine.queue
                        and not h.engine.pool.active_slots()):
                    h.state = "retired"
                    self.counters["pools_retired"] += 1
                    print("FABRIC POOL RETIRED pid=%d step=%d"
                          % (h.pid, self.now), flush=True)
                    self.pools.pop(h.pid, None)
                    self._release(h)
            self.now += 1
            return terminal

    def _maybe_inject_fault(self):
        """One fault-schedule slot per fabric step ('fabric' direction): a
        pool_kill action kills one live pool: 'pool_kill:<pid>' names the
        victim, a bare 'pool_kill' picks one from the schedule's seeded
        per-frame hash.  `pool_proc_kill` takes the same victim rule."""
        if self.faults is None:
            return
        idx, action = self.faults.next_action("fabric")
        base, _, arg = str(action).partition(":")
        if base not in ("pool_kill", "pool_proc_kill"):
            return
        live = sorted(self._live(), key=lambda h: h.pid)
        if not live:
            return
        if arg:
            pid = int(arg)
            if pid not in self.pools:
                return
        else:
            pick = int(self.faults.delay_fraction(idx) * len(live))
            pid = live[pick % len(live)].pid
        if base == "pool_proc_kill":
            self.proc_kill_pool(pid)
        else:
            self.kill_pool(pid)

    # ---- control plane -------------------------------------------------
    def stats(self):
        """The fabric's signal set: queue depth, mean live-pool occupancy,
        the cumulative rejection / re-placement counters, and per-pool
        detail with the speculation and prefix-cache counters."""
        with self._lock:
            live = self._live()
            occ = (sum(len(h.engine.pool.active_slots())
                       / float(h.engine.n_slots) for h in live)
                   / len(live)) if live else 0.0
            sub = max(1, self.counters["submitted"])
            per_pool = {}
            for h in self.pools.values():
                c = h.engine.counters
                prop = int(c.get("spec_proposed", 0))
                acc = int(c.get("spec_accepted", 0))
                per_pool[str(h.pid)] = {
                    "state": h.state,
                    "active_slots": len(h.engine.pool.active_slots()),
                    "n_slots": h.engine.n_slots,
                    "backlog": len(h.engine.queue),
                    "compile_count": h.engine.exe.compile_count,
                    # run-MEAN slot occupancy: active_slots reads 0 at any
                    # quiesced boundary
                    "mean_occupancy": round(
                        c["occupancy_sum"] / max(1, c["steps"]), 4),
                    "spec_proposed": prop,
                    "spec_accepted": acc,
                    "accept_rate": round(acc / float(prop), 4)
                    if prop else 1.0,
                    "prefix_hits": int(c.get("prefix_hits", 0)),
                    "prefix_misses": int(c.get("prefix_misses", 0)),
                    "prefix_tokens_reused": int(
                        c.get("prefix_tokens_reused", 0)),
                }
            s = dict(self.counters)
            s.update({
                "n_pools": len(live),
                "queue_depth": len([q for q in self.queue
                                    if q.arrival <= self.now]),
                "occupancy": round(occ, 4),
                "rejection_rate": round(
                    self.counters["rejected"] / float(sub), 4),
                "step": self.now,
                "prefixes_registered": len(self._prefixes),
                "pools": per_pool,
            })
            return s

    def control_service(self):
        """The router's side of the RPC control plane (ROADMAP A5.4b)."""
        raise NotImplementedError(
            "FabricRouter.control_service: the RPC control plane is not "
            "ported yet (%s)" % _NOT_PORTED)

    def serve_control(self, endpoint="127.0.0.1:0"):
        """Expose the control plane over RPC (ROADMAP A5.4b)."""
        raise NotImplementedError(
            "FabricRouter.serve_control: the RPC control plane is not "
            "ported yet (%s)" % _NOT_PORTED)

    # ---- episode loop --------------------------------------------------
    def run(self, requests=None, max_steps=100000, pool_schedule=None):
        """Serve `requests` to completion (plus anything queued).
        `pool_schedule` = [(fabric_step, delta)] or a 'T:+N,T:-N' string,
        the deterministic scaling schedule over scale_pools.  Returns
        (results, stats)."""
        if isinstance(pool_schedule, str):
            pool_schedule = parse_pool_schedule(pool_schedule)
        sched = sorted(pool_schedule or [], key=lambda e: e[0])
        for r in requests or []:
            self.submit(r)
        t0 = time.time()
        while True:
            with self._lock:
                busy = bool(self.queue) or any(
                    h.engine.queue or h.engine.pool.active_slots()
                    for h in self._routable())
                pending = bool(sched) or bool(self._pending_scale)
            if not busy and not pending:
                break
            while sched and sched[0][0] <= self.now:
                self.scale_pools(sched.pop(0)[1])
            self.step()
            if self.now >= max_steps:
                raise RuntimeError(
                    "fabric exceeded max_steps=%d with work pending"
                    % max_steps)
        wall = time.time() - t0
        stats = self.stats()
        stats["wall_s"] = round(wall, 4)
        new_tokens = sum(
            int(np.asarray(r["tokens"]).size)
            for r in self._results.values() if r["status"] == "OK")
        stats["new_tokens"] = new_tokens
        stats["tokens_per_s"] = (round(new_tokens / wall, 1)
                                 if wall else 0.0)
        return dict(self._results), stats
