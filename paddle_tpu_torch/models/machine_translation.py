"""GRU seq2seq translation model (the counterpart of
``paddle_tpu/models/machine_translation.py``; book
test_machine_translation and Paddle's
benchmark/fluid/models/machine_translation roles).

Encoder: embedding, then a GRU over the padded source.  Training
decoder: a GRU over [target embedding ; mean encoder state] at every
step, teacher-forced.  Decoding: one step program (re-encode the
source, additive attention from the previous hidden state, one GRU
step) driven by ``contrib.decoder.BeamSearchDecoder``.
"""

from .. import layers

__all__ = ["encoder", "decoder_train", "build_seq2seq_train",
           "build_decode_step"]


def encoder(src_ids, src_vocab, embed_dim=32, hidden_dim=32, seq_len=None):
    emb = layers.embedding(src_ids, size=[src_vocab, embed_dim],
                           dtype="float32")
    proj = layers.fc(emb, size=hidden_dim * 3, num_flatten_dims=2)
    return layers.dynamic_gru(proj, size=hidden_dim, seq_len=seq_len)


def _attention(dec_state, enc_out, hidden_dim):
    """Additive attention: scores = v . tanh(W_enc h_enc + W_dec h_dec)."""
    dec_proj = layers.fc(dec_state, size=hidden_dim, bias_attr=False)
    enc_proj = layers.fc(enc_out, size=hidden_dim, num_flatten_dims=2,
                         bias_attr=False)
    # [batch, T, H] + [batch, 1, H]
    mix = layers.tanh(
        layers.elementwise_add(enc_proj, layers.unsqueeze(dec_proj, [1])))
    scores = layers.fc(mix, size=1, num_flatten_dims=2, bias_attr=False)
    scores = layers.squeeze(scores, [2])  # [batch, T]
    weights = layers.softmax(scores)  # [batch, T]
    ctx = layers.matmul(layers.unsqueeze(weights, [1]), enc_out)  # [b, 1, H]
    return layers.squeeze(ctx, [1])


def decoder_train(enc_out, tgt_ids, tgt_vocab, embed_dim=32, hidden_dim=32):
    """Teacher-forced decoder over padded targets; returns the [b, T,
    vocab] softmax.  The step input is [embedding ; mean encoder state]:
    the mean-pooled summary stands in for per-step attention, which only
    the decode step computes."""
    emb = layers.embedding(tgt_ids, size=[tgt_vocab, embed_dim],
                           dtype="float32")
    ctx = layers.reduce_mean(enc_out, dim=1, keep_dim=True)
    ctx_rep = layers.expand(ctx, [1, emb.shape[1], 1])
    cell_in = layers.concat([emb, ctx_rep], axis=2)
    proj = layers.fc(cell_in, size=hidden_dim * 3, num_flatten_dims=2)
    dec = layers.dynamic_gru(proj, size=hidden_dim)
    return layers.fc(dec, size=tgt_vocab, num_flatten_dims=2, act="softmax")


def build_seq2seq_train(src_vocab, tgt_vocab, max_src=16, max_tgt=16,
                        embed_dim=32, hidden_dim=32):
    """Returns (feeds, avg_cost)."""
    src = layers.data("src_word_id", shape=[max_src], dtype="int64")
    tgt = layers.data("target_language_word", shape=[max_tgt], dtype="int64")
    lbl = layers.data("target_language_next_word", shape=[max_tgt],
                      dtype="int64")

    enc_out = encoder(src, src_vocab, embed_dim, hidden_dim)
    probs = decoder_train(enc_out, tgt, tgt_vocab, embed_dim, hidden_dim)
    flat = layers.reshape(probs, [-1, tgt_vocab])
    cost = layers.cross_entropy(flat, layers.reshape(lbl, [-1, 1]))
    return [src, tgt, lbl], layers.mean(cost)


def build_decode_step(src_vocab, tgt_vocab, max_src=16, embed_dim=32,
                      hidden_dim=32):
    """One decode step program for the BeamSearchDecoder: feeds (source
    ids, current token, previous hidden state) -> (log-probs, new hidden
    state)."""
    src = layers.data("src_word_id", shape=[max_src], dtype="int64")
    cur = layers.data("cur_token", shape=[1], dtype="int64")
    prev_h = layers.data("prev_hidden", shape=[hidden_dim])

    enc_out = encoder(src, src_vocab, embed_dim, hidden_dim)
    att = _attention(prev_h, enc_out, hidden_dim)
    emb = layers.embedding(cur, size=[tgt_vocab, embed_dim], dtype="float32")
    emb = layers.reshape(emb, [-1, embed_dim])
    cell_in = layers.concat([emb, att], axis=1)
    # a single GRU step: the padded GRU over T = 1 from the previous state
    proj = layers.fc(layers.unsqueeze(cell_in, [1]), size=hidden_dim * 3,
                     num_flatten_dims=2)
    dec = layers.dynamic_gru(proj, size=hidden_dim, h_0=prev_h)
    new_h = layers.squeeze(dec, [1])
    probs = layers.fc(new_h, size=tgt_vocab, act="softmax")
    logp = layers.log(probs)
    return [src, cur, prev_h], logp, new_h
