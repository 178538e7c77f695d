"""Contributed modules (the counterpart of ``paddle_tpu/contrib``): the
beam-search decoder."""
