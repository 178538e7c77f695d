"""Op lowerings; importing this package registers them all."""

from . import (compat_ops, math_ops, nn_ops, optimizer_ops,  # noqa: F401
               tensor_ops)
