"""Input helpers (the counterpart of ``paddle_tpu/reader``): sequence
packing for fixed-shape training."""

from .packing import pack_sequences

__all__ = ["pack_sequences"]
