"""Stacked dynamic-LSTM text classifier (the counterpart of
``paddle_tpu/models/stacked_dynamic_lstm.py``, after Paddle's
benchmark/fluid/models/stacked_dynamic_lstm.py): embedding, N stacked
LSTM layers, max pool over time, softmax, over padded sequences with
their lengths."""

from .. import layers

__all__ = ["build_stacked_lstm_train"]


def build_stacked_lstm_train(dict_size, seq_len_max, emb_dim=64,
                             hidden_dim=64, stacked_num=3, class_dim=2):
    """Returns (feed names, avg_loss, accuracy)."""
    from .sentiment import stacked_lstm_net

    data = layers.data("words", shape=[seq_len_max], dtype="int64")
    seq_len = layers.data("seq_len", shape=[], dtype="int64")
    label = layers.data("label", shape=[1], dtype="int64")
    pred = stacked_lstm_net(data, seq_len, dict_size, class_dim=class_dim,
                            emb_dim=emb_dim, hid_dim=hidden_dim,
                            stacked_num=stacked_num)
    loss = layers.mean(layers.cross_entropy(pred, label))
    acc = layers.accuracy(input=pred, label=label)
    return ["words", "seq_len", "label"], loss, acc
