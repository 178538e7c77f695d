"""Text classification over padded token sequences with length masks
(the counterpart of ``paddle_tpu/models/sentiment.py``), limited to the
stacked LSTM net: its convolution net needs sequence conv (ROADMAP
A6a)."""

from .. import layers

__all__ = ["stacked_lstm_net"]


def stacked_lstm_net(data, seq_len, input_dim, class_dim=2, emb_dim=32,
                     hid_dim=32, stacked_num=3):
    """Stacked LSTMs, every second one reversed, max-pooled over time, then
    a softmax classifier (book stacked_lstm_net / stacked_dynamic_lstm)."""
    assert stacked_num % 2 == 1
    emb = layers.embedding(data, size=[input_dim, emb_dim], dtype="float32")

    # dynamic_lstm contract: input pre-projected to 4 * hidden
    fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(fc1, size=hid_dim * 4, seq_len=seq_len)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        # multi-input fc == concat + fc (separate weights, summed)
        fc = layers.fc(inputs, size=hid_dim * 4, num_flatten_dims=2)
        lstm, _ = layers.dynamic_lstm(
            fc, size=hid_dim * 4, is_reverse=(i % 2) == 0, seq_len=seq_len)
        inputs = [fc, lstm]

    # max over the valid steps of each row
    fc_last = layers.sequence_pool(inputs[0], pool_type="max",
                                   seq_len=seq_len)
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max",
                                     seq_len=seq_len)
    return layers.fc([fc_last, lstm_last], size=class_dim, act="softmax")
