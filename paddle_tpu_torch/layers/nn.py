"""Neural-net layers (the counterpart of ``paddle_tpu/layers/nn.py``):
the builders the serving slice, the GPT-2 (modern-decoder options
included), WMT Transformer and BERT pretraining programs and the
recurrent models (stacked LSTM classifier, GRU seq2seq) and the conv
nets (ResNet, VGG, SE-ResNeXt, the MNIST CNN) call.  Each
appends ops through LayerHelper exactly as the reference does, so the
same calls generate the same var and parameter names."""

import numpy as np

from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "layer_norm", "mul", "matmul", "reshape", "transpose",
    "slice", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_min",
    "elementwise_pow", "gather", "fused_attention", "slot_cache_write",
    "dropout", "softmax", "softmax_with_cross_entropy", "label_smooth",
    "reduce_sum", "mean", "squeeze", "unsqueeze", "one_hot",
    "scale", "clip", "swish", "expand", "rotary_embed", "dynamic_lstm",
    "dynamic_gru", "cross_entropy", "topk", "reduce_mean", "log", "tanh",
    "sigmoid", "relu", "conv2d", "depthwise_conv2d", "pool2d",
    "adaptive_pool2d", "batch_norm",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected: per input a mul op, summed, bias, activation."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr_ in zip(
            helper.multiple_input(),
            helper.multiple_param_attr(len(helper.multiple_input()))):
        param_shape = [int(np.prod(input_var.shape[num_flatten_dims:]))] + [size]
        w = helper.create_parameter(attr=param_attr_, shape=param_shape,
                                    dtype=dtype, is_bias=False)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            "mul", inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = (-1 if padding_idx is None else padding_idx
                   if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        "lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"padding_idx": padding_idx, "is_sparse": bool(is_sparse),
               "is_distributed": bool(is_distributed)})
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype,
            is_bias=True)]
    mean_out = helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "mul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def _simple(op_type, x, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def tanh(x, name=None):
    return _simple("tanh", x, name=name)


def sigmoid(x, name=None):
    return _simple("sigmoid", x, name=name)


def relu(x, name=None):
    return _simple("relu", x, name=name)


def log(x, name=None):
    return _simple("log", x, name=name)


def clip(x, min, max, name=None):
    return _simple("clip", x, {"min": float(min), "max": float(max)}, name)


def swish(x, beta=1.0, name=None):
    return _simple("swish", x, {"beta": beta}, name)


def expand(x, expand_times, name=None):
    return _simple("expand", x, {"expand_times": list(expand_times)}, name)


def rotary_embed(x, pos=None, base=10000.0, name=None):
    """Rotary position embedding over per-head projections [B, H, T, Dh]
    (rotate-half); pos: none (arange(T)), [T], or per-row [B, T] (the
    ragged serving step)."""
    helper = LayerHelper("rotary_embed", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if pos is not None:
        inputs["Pos"] = [pos]
    helper.append_op("rotary_embed", inputs=inputs, outputs={"Out": [out]},
                     attrs={"base": base})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out) if act else out


def transpose(x, perm, name=None):
    return _simple("transpose2", x, {"axis": list(perm)}, name)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "slice", inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts),
               "ends": list(ends)})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    if act:
        helper.kwargs["act"] = act
        return helper.append_activation(out)
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "scale", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    if act:
        helper.kwargs["act"] = act
        return helper.append_activation(out)
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        "dropout", inputs={"X": [x]}, outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=True, name=None, axis=-1):
    return _simple("softmax", input, {"axis": axis}, name)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "cross_entropy", inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op("label_smooth", inputs=inputs, outputs={"Out": [out]},
                     attrs={"epsilon": epsilon})
    return out


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(op_type, inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def mean(x, name=None):
    """The mean of every element, as a [1] tensor."""
    return _simple("mean", x, name=name)


def squeeze(input, axes, name=None):
    return _simple("squeeze2", input, {"axes": list(axes)}, name)


def unsqueeze(input, axes, name=None):
    return _simple("unsqueeze2", input, {"axes": list(axes)}, name)


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"depth": depth})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def fused_attention(q, k, v, causal=False, scale=None, bias=None, window=0,
                    segment_ids=None, qstart=None, name=None):
    """Fused scaled-dot-product attention over [batch, heads, T, d]; a
    [batch] qstart keeps per-row offset-causal cutoffs (the ragged
    serving step)."""
    window = int(window)
    if window < 0:
        raise ValueError("fused_attention: window must be >= 0")
    if window and not causal:
        raise ValueError("fused_attention: window requires causal=True")
    if qstart is not None and not causal:
        raise ValueError("fused_attention: qstart requires causal=True "
                         "(it defines the global causal cutoffs)")
    helper = LayerHelper("fused_attention", **locals())
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    if segment_ids is not None:
        inputs["SegmentIds"] = [segment_ids]
    if qstart is not None:
        inputs["QStart"] = [qstart]
    helper.append_op("fused_attention", inputs=inputs, outputs={"Out": [out]},
                     attrs={"causal": causal, "scale": scale,
                            "window": int(window)})
    return out


def slot_cache_write(cache, new, pos, width, name=None):
    """Per-row ragged KV-cache write; returns the updated full-length
    cache (the caller assigns it back to the persistable var)."""
    helper = LayerHelper("slot_cache_write", **locals())
    out = helper.create_variable_for_type_inference(cache.dtype)
    helper.append_op("slot_cache_write",
                     inputs={"Cache": [cache], "New": [new], "Pos": [pos],
                             "Width": [width]},
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# recurrent layers over padded [batch, time, gates * hidden] input, the
# projection done by a preceding fc (the reference's dynamic_lstm contract)
# ---------------------------------------------------------------------------
def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 seq_len=None):
    """LSTM over padded [B, T, 4 hidden] input (size = 4 hidden): the
    padded_lstm op.  Returns (hidden [B, T, hidden], last cell [B,
    hidden])."""
    helper = LayerHelper("lstm", **locals())
    hidden_size = size // 4
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[hidden_size, 4 * hidden_size],
                                dtype=dtype)
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[4 * hidden_size], dtype=dtype,
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        "padded_lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "LastH": [last_h], "LastC": [last_c]},
        attrs={"is_reverse": is_reverse})
    return hidden, last_c


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, h_0=None, dtype="float32", name=None,
                seq_len=None):
    """GRU over padded [B, T, 3 size] projected input: the padded_gru
    op.  Returns the hidden sequence [B, T, size]."""
    helper = LayerHelper("gru", **locals())
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, 3 * size], dtype=dtype)
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op("padded_gru", inputs=inputs,
                     outputs={"Hidden": [hidden], "LastH": [last_h]},
                     attrs={"is_reverse": is_reverse})
    return hidden


# ---------------------------------------------------------------------------
# the conv nets
# ---------------------------------------------------------------------------
def _pair(v):
    return [v, v] if isinstance(v, int) else v


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """OIHW filters drawn from Normal(0, sqrt(2 / (kh kw C_in))), a bias
    over the channels (unless bias_attr is False), then `act`."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size, stride, padding, dilation = map(
        _pair, (filter_size, stride, padding, dilation))
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype,
                                default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def depthwise_conv2d(input, num_filters, filter_size, **kwargs):
    kwargs["groups"] = input.shape[1]
    return conv2d(input, num_filters, filter_size, **kwargs)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("adaptive_pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"ksize": list(pool_size),
                            "pooling_type": pool_type})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Scale = 1 and Bias = 0 as parameters; the moving Mean = 0 and
    Variance = 1 as non-trainable, stop-gradient persistables, which the
    op updates in place in training (MeanOut, VarianceOut name them)."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    param_shape = [channels]
    scale = helper.create_parameter(attr=helper.param_attr, shape=param_shape,
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, trainable=False),
        shape=param_shape, dtype=dtype, default_initializer=Constant(0.0))
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, trainable=False),
        shape=param_shape, dtype=dtype, default_initializer=Constant(1.0))
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)
