"""Model builders (the counterpart of ``paddle_tpu/models``)."""
