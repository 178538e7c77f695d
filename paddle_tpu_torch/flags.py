"""Runtime flag registry (the counterpart of ``paddle_tpu/flags.py``).

The same flags under the same names and defaults, loaded from the
environment at import in the same two forms:

* ``FLAGS_<name>=value``, one variable a flag;
* ``PADDLE_TPU_FLAGS="--name=value --other=v"``, the batch form.

``set_flags`` applies a mapping with the defaults' types.  The
liveness pair is validated at load and on ``set_flags``: an
``eviction_deadline`` at or below ``heartbeat_interval`` is clamped to
three intervals, with a warning.

No ported module reads a flag yet: each help text says so, and which
queue of ``ROADMAP.md`` ports the code that reads it.  None is dropped,
so a script's settings load unchanged.
"""

import os
import sys

__all__ = ["DEFINE_flag", "get_flag", "set_flags", "flag_items"]

_flags = {}


class _Flag:
    __slots__ = ("name", "value", "default", "help")

    def __init__(self, name, default, help):
        self.name = name
        self.default = default
        self.value = default
        self.help = help


def _coerce(default, raw):
    if isinstance(default, bool):
        return str(raw).lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def DEFINE_flag(name, default, help=""):
    f = _Flag(name, default, help)
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        f.value = _coerce(default, env)
    _flags[name] = f
    return f


def get_flag(name):
    return _flags[name].value


def set_flags(mapping):
    """name (with or without FLAGS_) -> value, coerced to the default's
    type; an unknown name raises KeyError."""
    for name, value in mapping.items():
        key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
        if key not in _flags:
            raise KeyError("unknown flag %s (known: %s)"
                           % (key, sorted(_flags)))
        f = _flags[key]
        f.value = _coerce(f.default, value)
    _validate_liveness_pair()


def _validate_liveness_pair():
    """An eviction_deadline at or below heartbeat_interval would evict
    healthy trainers between beats: warn and clamp it to 3 intervals."""
    if "eviction_deadline" not in _flags or "heartbeat_interval" not in _flags:
        return  # the registry is still loading
    hb = _flags["heartbeat_interval"].value
    ev = _flags["eviction_deadline"]
    if hb > 0 and ev.value <= hb:
        clamped = 3.0 * float(hb)
        sys.stderr.write(
            "WARNING: FLAGS_eviction_deadline=%.3g <= "
            "FLAGS_heartbeat_interval=%.3g would evict healthy trainers "
            "between beats; clamping eviction_deadline to %.3g\n"
            % (ev.value, hb, clamped))
        ev.value = clamped


def flag_items():
    return {name: f.value for name, f in sorted(_flags.items())}


def _parse_batch_env():
    for tok in os.environ.get("PADDLE_TPU_FLAGS", "").split():
        if tok.startswith("--") and "=" in tok:
            k, v = tok[2:].split("=", 1)
            if k in _flags:
                f = _flags[k]
                f.value = _coerce(f.default, v)


_UNREAD = "; no ported module reads it yet (ROADMAP %s)"
_PSERVER = _UNREAD % "A8, the pserver runtime"
_TOOLING = _UNREAD % "A9, the tooling"
_NONE = "; nothing in the port reads it: "
_COMPAT = "accepted so that a script's setting loads" + (
    _NONE + "PyTorch has no such knob")

DEFINE_flag("check_nan_inf", False,
            "scan every fetched value for NaN/Inf and raise" + (
                _UNREAD % "A9, the executor's checks"))
DEFINE_flag("benchmark", False,
            "log the wall time of every Executor.run" + _TOOLING)
DEFINE_flag("eager_delete_tensor_gb", -1.0, _COMPAT)
DEFINE_flag("fraction_of_gpu_memory_to_use", 0.92,
            "the device memory budget's fraction" + (
                _UNREAD % "A9, memory.py"))
DEFINE_flag("init_allocated_mem", False, _COMPAT)
DEFINE_flag("free_idle_memory", False, _COMPAT)
DEFINE_flag("paddle_num_threads", 1, _COMPAT)
DEFINE_flag("dist_threadpool_size", 0,
            "pserver threads (per connection in the reference)" + _PSERVER)
DEFINE_flag("rpc_deadline", 180000, "RPC timeout in ms" + _PSERVER)
DEFINE_flag("max_retry", 30, "RPC connect retries" + _PSERVER)
DEFINE_flag("heartbeat_interval", 2.0,
            "trainer -> pserver liveness heartbeat period in seconds (0 "
            "disables heartbeats and therefore eviction)" + _PSERVER)
DEFINE_flag("eviction_deadline", 20.0,
            "seconds without contact after which a heartbeat-tracked "
            "trainer is evicted from the sync round" + _PSERVER)
DEFINE_flag("enable_rpc_profiler", False,
            "RecordEvent spans around RPC calls" + _PSERVER)
DEFINE_flag("comm_bucket_bytes", 4 * 1024 * 1024,
            "size cap in bytes of the coalesced grad / param buckets of "
            "the pserver path (0: one send / recv a variable)" + _PSERVER)
DEFINE_flag("comm_wire_dtype", "float32",
            "wire dtype of dense bucket grads and fetched params on the "
            "pserver path: 'float32' or 'bfloat16'" + _PSERVER)
DEFINE_flag("comm_grad_int8", False,
            "int8 + error-feedback wire compression of dense bucket "
            "grads" + _PSERVER)
DEFINE_flag("ps_fused_apply", True,
            "pserver sync rounds apply the optimizer in one fused call a "
            "(optimizer, dtype) group of shard blocks" + _PSERVER)
DEFINE_flag("async_journal", True,
            "async pserver mode: a write-ahead journal of applied sparse "
            "chunks and dense buckets beside the checkpoint" + _PSERVER)
DEFINE_flag("async_staleness_bound", 0,
            "async pserver mode: the most steps a trainer may run ahead "
            "of the slowest live peer (0: unbounded)" + _PSERVER)
DEFINE_flag("sparse_hot_rows", 0,
            "async pserver mode: the trainer-side hot-row cache's "
            "capacity, rows a table (0 disables it)" + _PSERVER)
DEFINE_flag("sparse_hot_ttl", 8,
            "steps a hot-row cache entry may serve before it is fetched "
            "again" + _PSERVER)
DEFINE_flag("elastic_replan", True,
            "trainers re-derive their bucket / shard plan when a pserver "
            "mints a new plan epoch" + _PSERVER)
DEFINE_flag("comm_inflight", 4,
            "in-flight bucket RPCs a pserver endpoint" + _PSERVER)
DEFINE_flag("feed_prefetch", 2,
            "depth of the feed-prefetch double buffer (0 disables it)" + (
                _UNREAD % "A9, reader/decorator.py"))
DEFINE_flag("cudnn_deterministic", False,
            "deterministic cuDNN algorithms" + _NONE + "the port's conv "
            "ops set cuDNN's deterministic mode in their own guard")
DEFINE_flag("use_mkldnn", False, _COMPAT)
DEFINE_flag("use_pallas", False,
            "route the reference's hot ops to its Pallas kernels" + _NONE
            + "the port's kernel wrappers dispatch by the tensor's "
            "device")
DEFINE_flag("flash_block_q", 0,
            "flash-attention q-block rows (0: the kernel's default); the "
            "port's kernels take their tiles from flash_plan" + (
                _UNREAD % "A9, ops/kernel_tuning.py"))
DEFINE_flag("flash_block_k", 0,
            "flash-attention k-block columns (0: the default)" + (
                _UNREAD % "A9, ops/kernel_tuning.py"))
DEFINE_flag("kernel_tune_cache", "",
            "path of the persisted per-(kernel, shape bucket, dtype, "
            "device kind) tuning cache (empty: in memory)" + (
                _UNREAD % "A9, ops/kernel_tuning.py"))
DEFINE_flag("kernel_autotune", True,
            "allow the measured block-size search at a tuning-cache "
            "miss" + _UNREAD % "A9, ops/kernel_tuning.py")
DEFINE_flag("hbm_budget_bytes", 0,
            "peak-activation memory budget in bytes for the "
            "rematerialization pass (0 disables it)" + (
                _UNREAD % "A9, transpiler/remat.py"))
DEFINE_flag("program_tune_cache", "",
            "path of the persisted program-knob decision cache (empty: "
            "in memory)" + _UNREAD % "A9, transpiler/autotune.py")
DEFINE_flag("program_autotune", True,
            "allow the program-knob search at a decision-cache miss" + (
                _UNREAD % "A9, transpiler/autotune.py"))
DEFINE_flag("check_program", False,
            "verify the program after every registry pass and before "
            "each program version's first run" + (
                _UNREAD % "A9, analysis/"))
DEFINE_flag("prng_impl", "threefry",
            "the reference's JAX PRNG ('threefry' or 'rbg')" + _NONE
            + "the port draws from torch.Generator streams")
DEFINE_flag("tpu_bf16_matmul", False,
            "reserved in the reference" + _UNREAD % "A3, bf16")

_parse_batch_env()
_validate_liveness_pair()
