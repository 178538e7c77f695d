"""BERT-base pretraining (the counterpart of
``paddle_tpu/models/bert.py``): ``BertConfig`` (BERT-base by default),
``bert_encoder``, ``bert_pretrain_program`` (masked LM + next sentence,
fuse passes, backward, Adam) and ``make_fake_bert_batch``.

An encoder-only Transformer from the WMT model's blocks
(``transformer.encoder_layer``, the same parameter names): token +
segment + learned position embeddings, layer norm, N post-LN encoder
layers; a masked-LM head over every position (the masked slots chosen by
a weight feed) and a next-sentence head on the [CLS] vector.
``hp.fused_attn`` sends attention through ``fused_attention`` with the
rank-1 key-padding bias (the flash-attention kernels' key-bias form).

As in the reference, the programs are built under the current name
generator (no ``unique_name.guard()``), so the same generator state
gives the reference's parameter names, and weights cross between the
packages by name (``paddle_tpu_torch.io.params_from_numpy``).  Options
not ported yet raise: ``hp.recompute`` (ROADMAP A9).
``bert_pretrain_program``'s ``use_bf16`` applies ``bf16_amp_pass``; on
the card its attention runs B3's bf16 forms with ``fused_attn`` (the
key-padding bias float32) and matmul + softmax without, beside the bf16
forms of B5, B4 and the MLM transform's B1; the NSP head's
``softmax_with_cross_entropy`` stays float32 under the pass, so B7 runs
its float32 form.  Its ``mesh``
stamps the program with the family's training rules: the executor runs
the vocab projection's slab and raises for the trunk's entries (A7).
"""

import numpy as np

from .. import framework, layers, unique_name
from ..initializer import Normal
from ..param_attr import ParamAttr
from . import transformer as tfm

__all__ = ["BertConfig", "bert_encoder", "bert_pretrain_program",
           "make_fake_bert_batch"]


class BertConfig:
    """BERT-base (google-research/bert uncased_L-12_H-768_A-12): vocab
    30522, 2 segment types, 512 positions, hidden 768, 12 layers, 12
    heads, intermediate 3072, dropout 0.1."""

    vocab_size = 30522
    type_vocab_size = 2
    max_position = 512
    d_model = 768
    d_inner_hid = 3072
    n_head = 12
    n_layer = 12
    dropout = 0.1
    fused_attn = False
    recompute = False
    label_smooth_eps = 0.0  # the encoder blocks' field; unused here
    partition_family = "bert"


def _emb_table(name):
    return ParamAttr(name=unique_name.generate(name),
                     initializer=Normal(0.0, 0.02))


def bert_encoder(src_ids, seg_ids, attn_bias, hp, is_test=False,
                 kpad_bias=None):
    """[B, T] ids -> [B, T, d_model] sequence output."""
    if getattr(hp, "recompute", False) and not is_test:
        raise NotImplementedError("per-layer rematerialization "
                                  "(layers.recompute) is not ported yet "
                                  "(ROADMAP A9)")
    tok = layers.embedding(src_ids, size=[hp.vocab_size, hp.d_model],
                           param_attr=_emb_table("emb.w"))
    seg = layers.embedding(seg_ids, size=[hp.type_vocab_size, hp.d_model],
                           param_attr=_emb_table("seg_emb.w"))
    pos_table = layers.create_parameter(
        shape=[hp.max_position, hp.d_model], dtype="float32",
        attr=_emb_table("pos_emb.w"))
    pos = layers.slice(pos_table, axes=[0], starts=[0],
                       ends=[src_ids.shape[1]])
    x = layers.elementwise_add(layers.elementwise_add(tok, seg), pos, axis=1)
    x = layers.layer_norm(x, begin_norm_axis=2)
    if hp.dropout and not is_test:
        x = layers.dropout(x, hp.dropout, is_test=is_test)
    for _ in range(hp.n_layer):
        x = tfm.encoder_layer(x, attn_bias, hp, is_test, kpad_bias=kpad_bias)
    return x


def bert_pretrain_program(hp=BertConfig, seq_len=128, lr=1e-4, is_test=False,
                          use_bf16=False, mesh=None):
    """(main, startup, feeds, [total, mlm, nsp]) for MLM + NSP
    pretraining.  Feeds: src_ids / seg_ids [B, T] int64, input_mask
    [B, T] float (1 = real token), mlm_labels [B, T] int64, mlm_weight
    [B, T] float (1 at masked slots), nsp_label [B, 1] int64.

    The MLM loss is the weighted mean over every position (a batch with
    no masked slot gives 0, never 0/0), the NSP loss the mean over rows.
    linear_xent_fuse_pass (the [B, T, V] logits never exist) and
    matmul_epilogue_fuse_pass run before Adam.minimize, as in the
    reference, then use_bf16's bf16_amp_pass.  The reference's
    rematerialization hook emits nothing without its HBM-budget flag
    (FLAGS_hbm_budget_bytes, 0 by default), and its pass is not ported
    yet (ROADMAP A9), so nothing is emitted here either."""
    from .. import optimizer
    from ..transpiler.pass_registry import apply_pass

    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        src = layers.data("src_ids", shape=[seq_len], dtype="int64")
        seg = layers.data("seg_ids", shape=[seq_len], dtype="int64")
        mask = layers.data("input_mask", shape=[seq_len], dtype="float32")
        mlm_lbl = layers.data("mlm_labels", shape=[seq_len], dtype="int64")
        mlm_w = layers.data("mlm_weight", shape=[seq_len], dtype="float32")
        nsp_lbl = layers.data("nsp_label", shape=[1], dtype="int64")

        # additive key bias from the mask: 0 at real tokens, -1e9 at pads
        kpad = layers.scale(mask, scale=1e9, bias=-1e9)
        kpad.stop_gradient = True
        if getattr(hp, "fused_attn", False):
            attn_bias, kpad_bias = None, kpad
        else:
            attn_bias = layers.unsqueeze(layers.unsqueeze(kpad, [1]), [1])
            kpad_bias = None

        enc = bert_encoder(src, seg, attn_bias, hp, is_test, kpad_bias)

        mlm_h = layers.fc(enc, size=hp.d_model, num_flatten_dims=2,
                          act="gelu", param_attr=_emb_table("mlm_trans.w"))
        mlm_h = layers.layer_norm(mlm_h, begin_norm_axis=2)
        mlm_logits = layers.fc(mlm_h, size=hp.vocab_size, num_flatten_dims=2,
                               bias_attr=False,
                               param_attr=_emb_table("softmax_out.w"))
        mlm_cost = layers.softmax_with_cross_entropy(
            mlm_logits, layers.unsqueeze(mlm_lbl, [2]))
        mlm_cost = layers.elementwise_mul(mlm_cost,
                                          layers.unsqueeze(mlm_w, [2]))
        denom = layers.clip(layers.reduce_sum(mlm_w), 1e-5, 1e30)
        mlm_loss = layers.elementwise_div(layers.reduce_sum(mlm_cost), denom)

        cls = layers.squeeze(layers.slice(enc, axes=[1], starts=[0],
                                          ends=[1]), [1])
        pooled = layers.fc(cls, size=hp.d_model, act="tanh",
                           param_attr=_emb_table("pooler.w"))
        nsp_logits = layers.fc(pooled, size=2, param_attr=_emb_table("nsp.w"))
        nsp_loss = layers.mean(layers.softmax_with_cross_entropy(nsp_logits,
                                                                 nsp_lbl))
        total = layers.elementwise_add(mlm_loss, nsp_loss)

        apply_pass(main, "linear_xent_fuse_pass")
        apply_pass(main, "matmul_epilogue_fuse_pass")
        if use_bf16:
            apply_pass(main, "bf16_amp_pass")
        if not is_test:
            optimizer.Adam(learning_rate=lr).minimize(total)
    if mesh is not None:
        # the training stamp: the family's rules lifted to training names
        # (grads and Adam moments follow their param); the executor runs
        # the vocab projection's slab and raises for what is not ported
        from ..parallel.partition_rules import (annotate_spmd,
                                                train_partition_rules_for)

        annotate_spmd(main, mesh, train_partition_rules_for(
            getattr(hp, "partition_family", "bert")))
    feeds = ["src_ids", "seg_ids", "input_mask", "mlm_labels", "mlm_weight",
             "nsp_label"]
    return main, startup, feeds, [total, mlm_loss, nsp_loss]


def make_fake_bert_batch(batch_size, seq_len, hp=BertConfig, seed=0,
                         mask_frac=0.15):
    """A seeded synthetic batch: ragged lengths in [T/2, T], a segment
    split per row, about `mask_frac` of the real tokens masked (and
    always position 0), [MASK] id 1."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, hp.vocab_size, (batch_size, seq_len)).astype("int64")
    lens = rng.randint(seq_len // 2, seq_len + 1, (batch_size,))
    mask = (np.arange(seq_len)[None, :] < lens[:, None]).astype("float32")
    seg_split = rng.randint(1, seq_len, (batch_size,))
    seg = (np.arange(seq_len)[None, :] >= seg_split[:, None]).astype("int64")
    mlm_w = (rng.rand(batch_size, seq_len) < mask_frac).astype("float32") * mask
    mlm_w[:, 0] = 1.0
    labels = src.copy()
    src = np.where(mlm_w > 0, 1, src)
    nsp = rng.randint(0, 2, (batch_size, 1)).astype("int64")
    return {
        "src_ids": src, "seg_ids": seg, "input_mask": mask,
        "mlm_labels": labels, "mlm_weight": mlm_w, "nsp_label": nsp,
    }
