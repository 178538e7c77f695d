"""Model builders (the counterpart of ``paddle_tpu/models``): the WMT
Transformer, GPT-2 (with the modern-decoder options) and BERT
pretraining."""

from . import bert, decode_cache, gpt2, transformer  # noqa: F401

__all__ = ["bert", "decode_cache", "gpt2", "transformer"]
