"""Program passes; importing this package registers the fuse passes."""

from . import fuse_passes  # noqa: F401
from .pass_registry import OpPattern, Pass, apply_pass, get_pass, register_pass

__all__ = ["OpPattern", "Pass", "apply_pass", "get_pass", "register_pass"]
