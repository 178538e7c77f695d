"""Model builders (the counterpart of ``paddle_tpu/models``): the WMT
Transformer, GPT-2 (with the modern-decoder options), BERT pretraining,
the stacked dynamic-LSTM classifier, the GRU seq2seq model, the conv
nets (ResNet, VGG, SE-ResNeXt and the MNIST nets) and DeepFM."""

from . import (  # noqa: F401
    bert,
    ctr_deepfm,
    decode_cache,
    gpt2,
    machine_translation,
    mnist,
    resnet,
    se_resnext,
    sentiment,
    stacked_dynamic_lstm,
    transformer,
    vgg,
)

__all__ = ["bert", "ctr_deepfm", "decode_cache", "gpt2", "machine_translation", "mnist",
           "resnet", "se_resnext", "sentiment", "stacked_dynamic_lstm",
           "transformer", "vgg"]
