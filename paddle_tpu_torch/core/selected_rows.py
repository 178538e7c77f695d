"""SelectedRows: the sparse row-subset gradient (the counterpart of
``paddle_tpu/core/selected_rows.py``).

A (rows, value) pair standing for a ``[height, ...]`` tensor that is
zero outside ``rows``.  ``lookup_table_grad`` with ``is_sparse`` emits
one, and the sparse branches of the optimizer ops (``sgd``,
``momentum``, ``adam``, ``adagrad``) update only the touched rows, so a
CTR-scale table never has a ``[vocab, dim]`` gradient.  An op that does
not declare ``handles_selected_rows`` gets its SelectedRows inputs
densified by the block runner, and every fetch is densified.

Every shape is static (``N``, the lookup count), so a step that carries
one captures as a CUDA graph: no ``torch.unique``, ``nonzero`` or
boolean-mask indexing.  Duplicate ids are legal in ``rows``;
``merged()`` sums them.  Padding slots of a merged value hold row ==
height, as in the reference, whose scatters drop them (``mode="drop"``);
PyTorch's indexing raises there instead, so each consumer points them
at real rows (``densify`` here, ``slots`` for the optimizer ops): an add
of zero spread over the rows (``spread``), a set of the value a real
slot sets at that slot's row.
Duplicates are summed by ``index_put(accumulate=True)``, which sorts the
indices and sums each run in one fixed order on the card (the order
``ops/tensor_ops.py`` ``_Embedding`` relies on); ``index_add_`` and
``scatter_add_`` use float atomics, which would break captured == eager
bit for bit.
"""

import torch

__all__ = ["SelectedRows", "densify_maybe", "slots", "spread"]


class SelectedRows:
    def __init__(self, rows, value, height):
        self.rows = rows  # int64 [N]
        self.value = value  # [N, d...]
        self.height = int(height)  # the dense leading dim

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.value.shape[1:])

    def densify(self):
        """Sum the rows into the full [height, ...] tensor (padding slots
        add zeros, spread over the rows)."""
        mask = (self.rows < self.height).reshape(
            (-1,) + (1,) * (self.value.dim() - 1))
        value = torch.where(mask, self.value, torch.zeros_like(self.value))
        return self.value.new_zeros(self.dense_shape).index_put(
            (spread(self.rows, self.height),), value, accumulate=True)

    def scaled(self, s):
        return SelectedRows(self.rows, self.value * s, self.height)

    def astype(self, dtype):
        return SelectedRows(self.rows, self.value.to(dtype), self.height)

    def merged(self):
        """Duplicate rows summed (static [N] shapes: a stable sort, the
        run starts, a cumsum into compacted slots; the tail's padding
        slots get row == height and a zero value)."""
        n = self.rows.shape[0]
        if n == 0:
            return self
        r, order = torch.sort(self.rows, stable=True)
        v = self.value[order]
        is_new = torch.ones_like(r, dtype=torch.bool)
        is_new[1:] = r[1:] != r[:-1]
        seg = torch.cumsum(is_new, 0) - 1  # the compacted slot of each entry
        mv = torch.zeros_like(v).index_put((seg,), v, accumulate=True)
        mr = torch.full_like(r, self.height).index_put((seg,), r)
        return SelectedRows(mr, mv, self.height)


def densify_maybe(x):
    return x.densify() if isinstance(x, SelectedRows) else x


def spread(rows, height):
    """`rows` with each padding slot (row >= height) pointed at its slot
    index mod height, for an add of zero there: on the card the sorted
    accumulate walks one row's adds in sequence, so padding piled on one
    row (3,000 of a 4,096-id batch over 1,000 ids) would serialize."""
    pad = torch.arange(rows.shape[0], device=rows.device) % height
    return torch.where(rows < height, rows, pad)


def slots(merged):
    """(rows, value, valid, add_rows) of a merged SelectedRows: rows and
    value with every padding slot pointed at the last real slot (its row
    and its value), so a ``set`` at rows writes there what the real slot
    writes; ``valid`` (float, 1 for a real slot) zeroes the addend of an
    ``add``, which goes to add_rows (the padding spread).  The shapes
    stay [N]; a merged value has at least one real slot."""
    n = merged.rows.shape[0]
    real = merged.rows < merged.height
    last = real.sum() - 1
    src = torch.minimum(torch.arange(n, device=merged.rows.device), last)
    valid = real.to(merged.value.dtype).reshape(
        (-1,) + (1,) * (merged.value.dim() - 1))
    return (merged.rows[src], merged.value[src], valid,
            spread(merged.rows, merged.height))
