"""Model builders (the counterpart of ``paddle_tpu/models``): the WMT
Transformer, GPT-2 (with the modern-decoder options), BERT pretraining,
the stacked dynamic-LSTM classifier and the GRU seq2seq model."""

from . import (  # noqa: F401
    bert,
    decode_cache,
    gpt2,
    machine_translation,
    sentiment,
    stacked_dynamic_lstm,
    transformer,
)

__all__ = ["bert", "decode_cache", "gpt2", "machine_translation",
           "sentiment", "stacked_dynamic_lstm", "transformer"]
