"""Train a small causal LM on PACKED ragged sequences with
paddle_tpu_torch, end to end, on the CUDA card (``--cpu``: on the CPU):

    python examples/packed_training_torch.py [--cpu]

The port's counterpart of ``examples/packed_training.py``.  Ragged
token sequences (lengths 3..14) pack into fixed [N, 16] rows
(``reader.pack_sequences``).  Per-token segment ids keep attention
within each original sequence (``fused_attention(segment_ids=...)``:
the flash kernels' segment form on CUDA tensors, with ``window=`` their
sliding-window form too), per-segment positions index the position
table, and the loss masks padding (``segment_ids > 0``).  ``build()``
takes the widths as arguments, so the same program runs at GPT-2
small's widths on the card (``chip_smoke.py``).
"""

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, optimizer
from paddle_tpu_torch.reader import pack_sequences

VOCAB, L, D, HEADS = 40, 16, 32, 4


def build(n_rows, vocab=VOCAB, seq_len=L, d_model=D, heads=HEADS, window=0):
    """(main, startup, loss) of the packed LM over [n_rows, seq_len]
    feeds tokens, seg, pos and labels; `window` > 0 makes its one
    attention a causal sliding window of that many positions."""
    dh = d_model // heads
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens = layers.data("tokens", shape=[n_rows, seq_len], dtype="int64",
                             append_batch_size=False)
        seg = layers.data("seg", shape=[n_rows, seq_len], dtype="int32",
                          append_batch_size=False)
        pos = layers.data("pos", shape=[n_rows, seq_len], dtype="int64",
                          append_batch_size=False)
        labels = layers.data("labels", shape=[n_rows, seq_len],
                             dtype="int64", append_batch_size=False)

        emb = layers.embedding(tokens, size=[vocab, d_model])
        # positions restart per packed segment: gather rows of the
        # position table by the packed positions, not the row positions
        pos_table = layers.create_parameter(shape=[seq_len, d_model],
                                            dtype="float32")
        pos_emb = layers.reshape(
            layers.gather(pos_table, layers.reshape(pos, [n_rows * seq_len])),
            [n_rows, seq_len, d_model])
        x = layers.elementwise_add(emb, pos_emb)
        qkv = layers.reshape(
            layers.fc(x, size=3 * d_model, num_flatten_dims=2,
                      bias_attr=False),
            [n_rows, seq_len, 3, heads, dh])
        qkv = layers.transpose(qkv, [2, 0, 3, 1, 4])  # [3, N, H, L, Dh]
        q, k, v = (layers.reshape(
            layers.slice(qkv, axes=[0], starts=[i], ends=[i + 1]),
            [n_rows, heads, seq_len, dh]) for i in range(3))
        ctx = layers.fused_attention(q, k, v, causal=True, window=window,
                                     segment_ids=seg)
        ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]),
                             [n_rows, seq_len, d_model])
        logits = layers.fc(ctx, size=vocab, num_flatten_dims=2)
        loss_tok = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(labels, axes=[2]))
        # the mask derives from integer data, so no gradient flows
        # through it
        mask = layers.cast(layers.unsqueeze(seg, axes=[2]) > 0, "float32")
        denom = layers.reduce_sum(mask)
        loss = layers.reduce_sum(loss_tok * mask) / denom
        optimizer.Adam(3e-3).minimize(loss)
    return main, startup, loss


def make_feed(seqs, seq_len):
    """(feed, n_rows) of packed `seqs`: next-token labels within each
    segment; seg_for_loss is both the attention's segment ids and the
    loss mask, so a segment's last token (no label) joins the padding
    segment 0, as the reference example feeds it."""
    tokens, seg, pos = pack_sequences(seqs, seq_len)
    labels = np.roll(tokens, -1, axis=1)
    label_valid = (seg > 0) & (seg == np.roll(seg, -1, axis=1))
    seg_for_loss = np.where(label_valid, seg, 0).astype("int32")
    feed = {"tokens": tokens, "seg": seg_for_loss,
            "pos": pos.astype("int64"), "labels": labels}
    return feed, seg


def successor_sequences(n=24, seed=0):
    """Synthetic "language": token t is always followed by (t + 1) %
    VOCAB; lengths 3..14."""
    rng = np.random.RandomState(seed)
    seqs = []
    for _ in range(n):
        length = rng.randint(3, 15)
        start = rng.randint(0, VOCAB)
        seqs.append((start + np.arange(length)) % VOCAB)
    return seqs


def main(steps=60, place=None):
    """Train `steps` Adam steps on `place` (default: the card,
    ``fluid.default_place()``, which raises without one); returns the
    masked losses."""
    seqs = successor_sequences()
    feed, seg = make_feed(seqs, L)
    n_rows = seg.shape[0]
    print("packed %d ragged sequences into %d rows of %d (fill %.0f%%)"
          % (len(seqs), n_rows, L, 100.0 * (seg > 0).mean()))
    assert n_rows < len(seqs)

    main_p, startup, loss = build(n_rows)
    exe = fluid.Executor(place if place is not None else fluid.default_place())
    exe.run(startup)
    losses = []
    for step in range(steps):
        (lv,) = exe.run(main_p, feed=feed, fetch_list=[loss])
        losses.append(float(np.ravel(lv)[0]))
        if step % 20 == 0:
            print("step %d  masked loss %.4f" % (step, losses[-1]))
    print("final loss %.4f (from %.4f)" % (losses[-1], losses[0]))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    print("ok: the packed LM learned the successor rule")
    return losses


if __name__ == "__main__":
    import sys

    main(place=fluid.CPUPlace() if "--cpu" in sys.argv[1:] else None)
