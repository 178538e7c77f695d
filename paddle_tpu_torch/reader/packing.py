"""Sequence packing for fixed-shape training (the counterpart of
``paddle_tpu/reader/packing.py``; plain numpy).

Several short sequences share one fixed-length row; a per-token segment
id keeps attention (and the loss) within each original sequence
(``layers.fused_attention(segment_ids=...)``, the flash kernels'
segment form on the card), and per-segment positions restart so
positional encodings stay correct.  One shape serves ragged data at a
high fill rate, with no cross-sequence leakage.
"""

import numpy as np

__all__ = ["pack_sequences"]


def pack_sequences(seqs, seq_len, pad_id=0, dtype="int64"):
    """Pack variable-length token sequences into fixed [N, seq_len] rows
    (first-fit-decreasing bin packing).

    Returns ``(tokens, segment_ids, positions)``:

    - ``tokens`` [N, seq_len] `dtype`: the packed ids, `pad_id` in the
      unused tail.
    - ``segment_ids`` [N, seq_len] int32: 1, 2, ... per original
      sequence within its row, 0 on padding.  Feed to
      ``fused_attention(segment_ids=...)`` (padding shares id 0 with
      other padding only: real tokens never attend it) and use
      ``segment_ids > 0`` as the loss mask.
    - ``positions`` [N, seq_len] int32: 0-based position within each
      segment (restarts at every boundary), 0 on padding.

    Sequences longer than `seq_len`, and empty ones, raise.
    """
    seqs = [np.asarray(s).ravel() for s in seqs]
    for s in seqs:
        if s.size > seq_len:
            raise ValueError(
                "pack_sequences: sequence of length %d exceeds seq_len=%d "
                "— truncate or bucket upstream" % (s.size, seq_len))
        if s.size == 0:
            raise ValueError("pack_sequences: empty sequence")
    # first-fit-decreasing: longest first (a stable sort, so equal lengths
    # keep their input order), into the first row that fits
    order = sorted(range(len(seqs)), key=lambda i: -seqs[i].size)
    rows, space = [], []  # seq indices per row, remaining room per row
    for i in order:
        n = seqs[i].size
        for r, free in enumerate(space):
            if n <= free:
                rows[r].append(i)
                space[r] -= n
                break
        else:
            rows.append([i])
            space.append(seq_len - n)

    tokens = np.full((len(rows), seq_len), pad_id, dtype=dtype)
    segment_ids = np.zeros((len(rows), seq_len), np.int32)
    positions = np.zeros((len(rows), seq_len), np.int32)
    for r, members in enumerate(rows):
        off = 0
        for sid, i in enumerate(members, start=1):
            s = seqs[i]
            tokens[r, off:off + s.size] = s
            segment_ids[r, off:off + s.size] = sid
            positions[r, off:off + s.size] = np.arange(s.size)
            off += s.size
    return tokens, segment_ids, positions
