"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style surface (Program / Block / Operator IR, layer
builders, Executor, serving engine) over PyTorch tensors, with the
reference's TPU kernels rewritten by hand for NVIDIA Hopper
(``paddle_tpu_torch/kernels``).  This package imports torch and numpy
only: never jax, and nothing of ``paddle_tpu``.

    import paddle_tpu_torch as fluid
    exe = fluid.Executor()               # CUDAPlace(0); raises with no GPU
    exe = fluid.Executor(fluid.CPUPlace())

The port grows slice by slice: continuous-batching serving of GPT-2
(``serving.ServingEngine``, the modern-decoder options included),
KV-cached decoding, and training of the WMT Transformer, GPT-2, BERT,
the stacked dynamic LSTM, the GRU seq2seq model and the conv nets
(ResNet, VGG, SE-ResNeXt, the MNIST CNN) (``models``), and of a causal
LM on packed sequences (``reader.pack_sequences``); and the inference
deployment path: ``save_inference_model`` / ``load_inference_model``
(``io``), the ``InferenceTranspiler`` and the ``AnalysisConfig``
predictor (``inference``); and DeepFM CTR training with sparse
embeddings (``models.ctr_deepfm``: SelectedRows gradients, every
optimizer, ``clip``, ``regularizer``).
"""

from . import ops  # noqa: F401  (registers the op lowerings)
from . import inference, io, layers, nets, transpiler, unique_name  # noqa: F401
from . import backward, clip, flags, framework, initializer  # noqa: F401
from . import optimizer, param_attr, places, regularizer  # noqa: F401
from .core.scope import Scope, global_scope, scope_guard
from .executor import Executor, as_numpy
from .framework import (
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    cpu_places,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)
from .io import (
    load_inference_model,
    load_params,
    load_persistables,
    load_vars,
    save_inference_model,
    save_params,
    save_persistables,
    save_vars,
)
from .param_attr import ParamAttr, WeightNormParamAttr
from .places import CPUPlace, CUDAPlace, default_place, is_compiled_with_cuda
from .transpiler import (InferenceTranspiler, list_passes, memory_optimize,
                         release_memory)

__all__ = [
    "Block", "CPUPlace", "CUDAPlace", "Executor", "InferenceTranspiler",
    "Operator", "ParamAttr", "Parameter", "Program", "Scope", "Variable",
    "WeightNormParamAttr", "as_numpy", "backward", "clip", "cpu_places",
    "default_main_program", "default_place", "default_startup_program",
    "flags", "framework", "global_scope", "inference", "initializer", "io",
    "is_compiled_with_cuda", "layers", "list_passes", "load_inference_model",
    "load_params", "load_persistables", "load_vars", "memory_optimize",
    "name_scope", "nets", "optimizer", "param_attr", "places",
    "program_guard", "regularizer", "release_memory", "save_inference_model",
    "save_params", "save_persistables", "save_vars", "scope_guard",
    "unique_name",
]
