"""Inference predictor (the counterpart of ``paddle_tpu/inference``):
load a saved inference model, run the analysis passes over it and
serve it through an Executor.

    config = AnalysisConfig(model_dir)     # place None: CUDAPlace(0)
    predictor = create_paddle_predictor(config)
    outs = predictor.run({"image": batch})

``AnalysisConfig``'s pipeline is the reference's twelve passes in the
reference's order (batch-norm fold, attention fusion, the fc and
recurrent fusions, the conv and elementwise fusions, the is_test
rewrite, the memory plan), resolved through the pass registry, so a
user-registered pass runs like a built-in one.  The predictor serves
through ``Executor.run``: its second run of a feed signature replays a
captured CUDA graph on the card.  ``enable_int8`` waits for
``contrib/quantize`` (ROADMAP A6c).
"""

import numpy as np

from .. import framework, io
from ..core.scope import Scope
from ..executor import Executor, as_numpy

__all__ = [
    "NativeConfig",
    "AnalysisConfig",
    "Predictor",
    "PaddleTensor",
    "ZeroCopyTensor",
    "create_paddle_predictor",
]


class NativeConfig:
    """Plain load-and-run config."""

    def __init__(self, model_dir=None, place=None):
        self.model_dir = model_dir
        self.place = place
        self.model_filename = None
        self.params_filename = None
        self.ir_optim = False


class AnalysisConfig(NativeConfig):
    """Adds the analysis pass pipeline."""

    def __init__(self, model_dir=None, place=None):
        super().__init__(model_dir, place)
        self.ir_optim = True
        self.int8 = False
        # attention fusion runs BEFORE drop_train_ops: the dropout-aware
        # attention patterns must see the original dropout op
        self._passes = [
            "fold_batch_norm",
            "attention_fuse_pass",
            # fc_fuse first: the recurrent and embedding fuses match its
            # output
            "fc_fuse_pass",
            "embedding_fc_lstm_fuse_pass",
            "fc_gru_fuse_pass",
            "fc_lstm_fuse_pass",
            "conv_eltadd_relu_fuse_pass",
            "seqconv_eltadd_relu_fuse_pass",
            "seqexpand_concat_fc_fuse_pass",
            "fuse_elewise_add_act_pass",
            "drop_train_ops",
            "memory_optimize",
        ]

    def switch_ir_optim(self, flag=True):
        self.ir_optim = bool(flag)
        return self

    def enable_int8(self, quantize_transpiler=None):
        raise NotImplementedError(
            "AnalysisConfig.enable_int8: int8 serving (contrib/quantize's "
            "freeze_program and convert_to_int8) is not ported yet "
            "(ROADMAP A6c)")

    def pass_builder(self):
        return self._passes


class Predictor:
    """Serving handle: a private scope, the loaded program after its
    passes, and an Executor on the config's place."""

    # the pass_builder's legacy names -> registered pass names
    _PASS_ALIASES = {
        "fold_batch_norm": "conv_bn_fuse_pass",
        "drop_train_ops": "is_test_pass",
        "memory_optimize": "memory_optimize_pass",
    }

    def __init__(self, config):
        self.config = config
        self.scope = Scope()
        self._zero_copy_outputs = {}
        self.exe = Executor(config.place)
        self.program, self.feed_names, self.fetch_vars = \
            io.load_inference_model(
                config.model_dir, self.exe,
                model_filename=config.model_filename,
                params_filename=config.params_filename, scope=self.scope)
        self.program._is_test = True
        if config.ir_optim:
            self._apply_analysis_passes()
        self.fetch_names = [
            v.name if isinstance(v, framework.Variable) else v
            for v in self.fetch_vars]

    def _apply_analysis_passes(self):
        """Resolve the config's pass list through the registry (every
        name first, before any pass mutates the program), protect the
        fetch targets, and apply the passes in order."""
        from ..transpiler import apply_pass, get_pass

        passes = (self.config.pass_builder()
                  if isinstance(self.config, AnalysisConfig)
                  else ["fold_batch_norm", "drop_train_ops"])
        resolved = [self._PASS_ALIASES.get(n, n) for n in passes]
        for name in resolved:
            get_pass(name)
        self.program._protected_fetch_names = {
            v.name if isinstance(v, framework.Variable) else v
            for v in self.fetch_vars}
        for name in resolved:
            apply_pass(self.program, name, scope=self.scope)

    def run(self, inputs):
        """inputs: a dict name -> array, a list aligned with the feed
        names, or a list of PaddleTensor (then PaddleTensor outputs).
        Returns numpy arrays aligned with the fetch targets."""
        tensor_mode = (isinstance(inputs, (list, tuple)) and inputs
                       and isinstance(inputs[0], PaddleTensor))
        if tensor_mode:
            feed = {t.name or n: t.data
                    for t, n in zip(inputs, self.feed_names)}
        elif not isinstance(inputs, dict):
            feed = dict(zip(self.feed_names, inputs))
        else:
            feed = inputs
        outs = self.exe.run(self.program, feed=feed,
                            fetch_list=self.fetch_names, scope=self.scope)
        if tensor_mode:
            return [PaddleTensor(np.asarray(o), name=n)
                    for o, n in zip(outs, self.fetch_names)]
        return [np.asarray(o) for o in outs]

    # ---- zero-copy serving ---------------------------------------------
    def get_input_tensor(self, name):
        if name not in self.feed_names:
            raise KeyError("unknown input '%s' (have %s)"
                           % (name, self.feed_names))
        handles = getattr(self, "_zero_copy_inputs", None)
        if handles is None:
            handles = self._zero_copy_inputs = {}
        if name not in handles:
            handles[name] = ZeroCopyTensor(self, name, is_input=True)
        return handles[name]

    def get_output_tensor(self, name):
        if name not in self.fetch_names:
            raise KeyError("unknown output '%s' (have %s)"
                           % (name, self.fetch_names))
        return ZeroCopyTensor(self, name, is_input=False)

    def zero_copy_run(self):
        """Run from the bound input buffers; the outputs stay tensors on
        the executor's device, read through
        get_output_tensor(...).copy_to_cpu()."""
        handles = getattr(self, "_zero_copy_inputs", {})
        missing = [n for n in self.feed_names
                   if n not in handles or handles[n]._buf is None]
        if missing:
            raise RuntimeError(
                "zero_copy_run: inputs %s not bound — get_input_tensor + "
                "reshape/copy_from_cpu first" % missing)
        feed = {n: handles[n]._buf for n in self.feed_names}
        outs = self.exe.run(self.program, feed=feed,
                            fetch_list=self.fetch_names, scope=self.scope,
                            return_numpy=False)
        self._zero_copy_outputs = dict(zip(self.fetch_names, outs))
        return True

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return list(self.fetch_names)

    def clone(self):
        """A predictor sharing this one's scope (its weights) and
        program, with an Executor (and so a cache of captured steps) of
        its own."""
        cloned = Predictor.__new__(Predictor)
        cloned.config = self.config
        cloned._zero_copy_outputs = {}
        cloned.scope = self.scope
        cloned.exe = Executor(self.config.place)
        cloned.program = self.program
        cloned.feed_names = list(self.feed_names)
        cloned.fetch_vars = self.fetch_vars
        cloned.fetch_names = list(self.fetch_names)
        return cloned


class PaddleTensor:
    """Named host tensor of the Run(inputs) -> outputs call: name, data
    (a numpy array) and lod (offset lists)."""

    def __init__(self, data=None, name="", lod=None):
        self.name = name
        self.data = None if data is None else np.asarray(data)
        self.lod = [list(l) for l in (lod or [])]

    @property
    def shape(self):
        return [] if self.data is None else list(self.data.shape)

    @property
    def dtype(self):
        return None if self.data is None else str(self.data.dtype)


class ZeroCopyTensor:
    """A predictor's input or output handle.  An input's buffer, filled
    through mutable_data() or copy_from_cpu(), is what the executor
    stages, with no copy of it in between; an output's copy_to_cpu() is
    the one device-to-host copy of the executor's output."""

    def __init__(self, predictor, name, is_input):
        self._pred = predictor
        self._name = name
        self._is_input = is_input
        self._buf = None

    def name(self):
        return self._name

    def reshape(self, shape):
        """Allocate (or keep) the input buffer: reshape first, then
        write."""
        shape = tuple(int(d) for d in shape)
        if self._buf is None or self._buf.shape != shape:
            dtype = self._buf.dtype if self._buf is not None else np.float32
            self._buf = np.zeros(shape, dtype)
        return self

    def mutable_data(self, dtype="float32"):
        if not self._is_input:
            raise RuntimeError("mutable_data is for input tensors")
        if self._buf is None:
            raise RuntimeError("call reshape(shape) before mutable_data()")
        if str(self._buf.dtype) != str(np.dtype(dtype)):
            self._buf = self._buf.astype(dtype)
        return self._buf

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu is for input tensors")
        self._buf = np.ascontiguousarray(arr)
        return self

    def copy_to_cpu(self):
        if self._is_input:
            return np.asarray(self._buf)
        out = self._pred._zero_copy_outputs.get(self._name)
        if out is None:
            raise RuntimeError(
                "no output for '%s' yet — call zero_copy_run() first"
                % self._name)
        return as_numpy(out)

    def shape(self):
        if self._is_input:
            return [] if self._buf is None else list(self._buf.shape)
        out = self._pred._zero_copy_outputs.get(self._name)
        return [] if out is None else list(out.shape)

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]

    def lod(self):
        return getattr(self, "_lod", [])


def create_paddle_predictor(config):
    return Predictor(config)
