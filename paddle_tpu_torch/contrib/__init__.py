"""Contributed modules (the counterpart of ``paddle_tpu/contrib``): the
beam-search decoder and bf16 automatic mixed precision
(``mixed_precision``)."""
