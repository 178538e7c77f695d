"""Op lowerings; importing this package registers them all."""

from . import (compat_ops, image_ops, loss_ops, math_ops,  # noqa: F401
               metric_ops, nn_ops, optimizer_ops, tensor_ops)
