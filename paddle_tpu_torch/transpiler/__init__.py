"""Program passes; importing this package registers the fuse passes."""

from . import fuse_passes  # noqa: F401
from .inference_transpiler import InferenceTranspiler
from .layout_transpiler import rewrite_nhwc
from .memory_optimization_transpiler import memory_optimize, release_memory
from .pass_registry import (OpPattern, Pass, apply_pass, get_pass,
                            list_passes, register_pass)

__all__ = ["InferenceTranspiler", "OpPattern", "Pass", "apply_pass",
           "get_pass", "list_passes", "memory_optimize", "register_pass",
           "release_memory", "rewrite_nhwc"]
