"""Op lowerings; importing this package registers them all."""

from . import (compat_ops, loss_ops, math_ops, metric_ops,  # noqa: F401
               nn_ops, optimizer_ops, tensor_ops)
