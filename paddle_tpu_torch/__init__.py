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
the stacked dynamic LSTM and the GRU seq2seq model (``models``), and of
a causal LM on packed sequences (``reader.pack_sequences``).
"""

from . import ops  # noqa: F401  (registers the op lowerings)
from . import layers, transpiler, unique_name  # noqa: F401
from .core.scope import Scope, global_scope, scope_guard
from .executor import Executor
from .framework import (
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .places import CPUPlace, CUDAPlace, default_place

__all__ = [
    "CPUPlace", "CUDAPlace", "Executor", "Program", "Scope",
    "default_main_program", "default_place", "default_startup_program",
    "global_scope", "layers", "program_guard", "scope_guard", "unique_name",
]
