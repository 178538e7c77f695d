"""Input layers (the counterpart of ``paddle_tpu/layers/io.py``): ``data``
declares a feed slot."""

from .. import framework

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=None, stop_gradient=True):
    """Declare an input variable; `append_batch_size` prepends a -1 batch
    dim as in the reference."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return framework.default_main_program().current_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
