"""Liveness-based memory planning (the counterpart of
``paddle_tpu/transpiler/memory_optimization_transpiler.py``):
``ControlFlowGraph``, ``memory_optimize`` and ``release_memory``.

As in the reference, the plan is recorded, not applied: a reuse plan
(which non-persistable vars may share storage, keyed by (dtype, shape))
with its estimated saving, as ``program._memory_opt_plan``, and the
vars that die before the block's last op, as ``program._donate_vars``.
No executor of either package reads them: the port's executor holds a
step's buffers in its cache entry and PyTorch's caching allocator
reuses freed blocks inside the step.
"""

_DTYPE_SIZE = {
    "float32": 4,
    "float64": 8,
    "float16": 2,
    "bfloat16": 2,
    "int64": 8,
    "int32": 4,
    "int16": 2,
    "int8": 1,
    "uint8": 1,
    "bool": 1,
}


def _numel(shape):
    n = 1
    for d in shape or [1]:
        d = int(d)
        if d < 0:
            d = 1  # dynamic batch dim: count one row
        n *= d
    return n


class ControlFlowGraph:
    """Def/use and liveness over one block's op list (analysis.graph's
    def_use_lists)."""

    def __init__(self, program, block_idx=0):
        from ..analysis.graph import def_use_lists

        self.program = program
        self.block = program.block(block_idx)
        self.ops = self.block.ops
        self.defs, self.uses = def_use_lists(program, block_idx)

    def live_ranges(self):
        """var -> (first def idx, last use idx)."""
        first_def = {}
        last_use = {}
        for i, op in enumerate(self.ops):
            for n in self.uses[i]:
                last_use[n] = i
            for n in self.defs[i]:
                first_def.setdefault(n, i)
                last_use[n] = max(last_use.get(n, i), i)
        return {n: (first_def[n], last_use.get(n, first_def[n]))
                for n in first_def}


def _var_bytes(block, name):
    v = block._find_var_recursive(name)
    if v is None:
        return 0, None
    size = _DTYPE_SIZE.get(str(v.dtype), 4)
    return _numel(v.shape) * size, v


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    """The reuse plan and donation set of `input_program`: greedy
    first-fit over a pool of dead vars, walking the ops in order, a var
    reusing only a dead var of its own (dtype, shape).  Returns
    {"reuse": {var: cache_var}, "saved_bytes": int, "refused_mismatch":
    int}; also stored as program._memory_opt_plan, with
    program._donate_vars."""
    skip = set(skip_opt_set or ())
    block = input_program.global_block()
    cfg = ControlFlowGraph(input_program)
    ranges = cfg.live_ranges()

    def reusable(name):
        if name in skip:
            return False
        v = block._find_var_recursive(name)
        if v is None or v.persistable:
            return False
        return not getattr(v, "is_data", False)

    def var_key(name):
        """(dtype, shape): aliasing is sound only between identically
        typed, identically shaped slots."""
        v = block._find_var_recursive(name)
        if v is None:
            return None
        return (str(v.dtype), tuple(int(d) for d in (v.shape or ())))

    reuse = {}
    saved = 0
    refused_mismatch = 0
    free_pool = []  # (name, bytes, (dtype, shape)) of dead vars
    deaths = {}
    for name, (d, u) in ranges.items():
        deaths.setdefault(u, []).append(name)
    for i in range(len(cfg.ops)):
        for name in cfg.defs[i]:
            if not reusable(name) or name in reuse:
                continue
            nbytes, v = _var_bytes(block, name)
            if nbytes == 0:
                continue
            key = var_key(name)
            matched = False
            for j, (cand, cbytes, ckey) in enumerate(free_pool):
                if ckey == key and key is not None:
                    reuse[name] = cand
                    saved += nbytes
                    free_pool.pop(j)
                    matched = True
                    break
            if not matched and any(
                    cbytes >= nbytes and ckey != key
                    for _, cbytes, ckey in free_pool):
                refused_mismatch += 1  # a bytes-only match was refused
        for name in deaths.get(i, []):
            if reusable(name) and name not in reuse:
                nbytes, _ = _var_bytes(block, name)
                if nbytes:
                    free_pool.append((name, nbytes, var_key(name)))

    bad = [(n, c) for n, c in sorted(reuse.items())
           if var_key(n) != var_key(c)]
    if bad:  # pragma: no cover
        raise AssertionError("memory_optimize produced unsound aliases: %s"
                             % bad)

    donate = sorted(n for n, (d, u) in ranges.items()
                    if reusable(n) and u < len(cfg.ops) - 1
                    and n not in reuse)
    plan = {"reuse": reuse, "saved_bytes": saved,
            "refused_mismatch": refused_mismatch}
    if refused_mismatch and print_log:
        print("memory_optimize: refused %d numel-compatible but "
              "dtype/shape-mismatched alias candidates" % refused_mismatch)
    input_program._memory_opt_plan = plan
    input_program._donate_vars = donate
    if print_log:
        print("memory_optimize: %d vars share storage, ~%.1f MB saved (plan "
              "recorded)" % (len(reuse), saved / 1e6))
    return plan


def release_memory(input_program, skip_opt_set=None):
    """The vars that die early (the donation set), recorded on the
    program."""
    memory_optimize(input_program, skip_opt_set=skip_opt_set)
    return input_program._donate_vars
