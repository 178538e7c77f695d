"""DeepFM CTR model (the counterpart of
``paddle_tpu/models/ctr_deepfm.py``; ``BASELINE.json`` config 4).

Sparse id fields -> first-order weights + the FM pairwise interactions
(the sum-square trick) + a DNN over the concatenated embeddings ->
sigmoid.  With ``is_sparse`` each table's gradient is a SelectedRows
(``core/selected_rows.py``): the looked-up rows only.
``is_distributed`` is kept as the lookups' attribute, which the
reference's DistributeTranspiler reads to shard the tables over
pservers; running such a table is ROADMAP A8."""

from .. import layers
from ..param_attr import ParamAttr


def deepfm(sparse_ids, dense_input, sparse_field_dims, embed_dim=8,
           dnn_dims=(32, 32), is_sparse=False, is_distributed=False):
    """sparse_ids: int64 [batch, 1] vars, one a field; dense_input: a
    [batch, D] float var or None.  Returns the sigmoid CTR prediction
    [batch, 1]."""
    first = []
    for i, (ids, dim) in enumerate(zip(sparse_ids, sparse_field_dims)):
        w = layers.embedding(
            ids, size=[dim, 1], dtype="float32", is_sparse=is_sparse,
            is_distributed=is_distributed,
            param_attr=ParamAttr(name="fm_w1_%d" % i))
        first.append(layers.reshape(w, [-1, 1]))
    y_first = layers.sum(first)

    # second order: the sum-square trick over the field embeddings
    embs = []
    for i, (ids, dim) in enumerate(zip(sparse_ids, sparse_field_dims)):
        e = layers.embedding(
            ids, size=[dim, embed_dim], dtype="float32", is_sparse=is_sparse,
            is_distributed=is_distributed,
            param_attr=ParamAttr(name="fm_v_%d" % i))
        embs.append(layers.reshape(e, [-1, 1, embed_dim]))
    stacked = layers.concat(embs, axis=1)  # [b, fields, k]
    sum_sq = layers.pow(layers.reduce_sum(stacked, dim=1), 2.0)
    sq_sum = layers.reduce_sum(layers.pow(stacked, 2.0), dim=1)
    y_second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True),
        scale=0.5)

    deep_in = layers.reshape(stacked, [-1, len(sparse_ids) * embed_dim])
    if dense_input is not None:
        deep_in = layers.concat([deep_in, dense_input], axis=1)
    for d in dnn_dims:
        deep_in = layers.fc(deep_in, size=d, act="relu")
    y_deep = layers.fc(deep_in, size=1)

    logit = layers.elementwise_add(
        layers.elementwise_add(y_first, y_second), y_deep)
    return layers.sigmoid(logit)


def build_deepfm_train(sparse_field_dims, dense_dim=4, embed_dim=8,
                       is_sparse=False, with_auc=False,
                       is_distributed=False):
    """(feeds, avg_loss, pred), or with `with_auc` (feeds, avg_loss,
    pred, auc, batch_auc): the streaming global AUC and the batch AUC
    over the last 20 batches.  Feeds C0..C<n-1> (int64 [batch, 1]),
    dense ([batch, dense_dim], where dense_dim) and click ([batch, 1]
    float)."""
    sparse_ids = [layers.data("C%d" % i, shape=[1], dtype="int64")
                  for i in range(len(sparse_field_dims))]
    dense = layers.data("dense", shape=[dense_dim]) if dense_dim else None
    label = layers.data("click", shape=[1])
    pred = deepfm(sparse_ids, dense, sparse_field_dims, embed_dim,
                  is_sparse=is_sparse, is_distributed=is_distributed)
    loss = layers.mean(layers.log_loss(pred, label, epsilon=1e-6))
    feeds = sparse_ids + ([dense] if dense is not None else []) + [label]
    if with_auc:
        auc_var, batch_auc, _states = layers.auc(
            layers.reshape(pred, [-1]), layers.cast(label, "int64"),
            num_thresholds=2 ** 12 - 1, slide_steps=20)
        return feeds, loss, pred, auc_var, batch_auc
    return feeds, loss, pred
