"""SE-ResNeXt (the counterpart of ``paddle_tpu/models/se_resnext.py``):
grouped 3x3 convs (cardinality 32 by default, one conv with `groups`)
and squeeze-and-excitation blocks; depth 50 has stages [3, 4, 6, 3]."""

from .. import layers

__all__ = ["se_resnext"]


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=max(1, num_channels // reduction_ratio),
                        act="relu")
    excitation = layers.fc(squeeze, size=num_channels, act="sigmoid")
    # scale the channels: [N, C, H, W] * [N, C], aligned at axis 0
    return layers.elementwise_mul(input, excitation, axis=0)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, cardinality=32,
                     reduction_ratio=16, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(short, scaled))


def se_resnext(input, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, is_test=False, stages=None,
               num_filters=None):
    """`stages` and `num_filters` override the depth's block counts and
    the stages' widths (a narrow config)."""
    if stages is None:
        assert depth in (50, 101, 152)
        stages = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                  152: [3, 8, 36, 3]}[depth]
    num_filters = num_filters or [128, 256, 512, 1024]

    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu", is_test=is_test)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for stage, count in enumerate(stages):
        for i in range(count):
            conv = bottleneck_block(
                conv, num_filters[stage],
                stride=2 if i == 0 and stage != 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio,
                is_test=is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2, is_test=is_test)
    return layers.fc(drop, size=class_dim, act="softmax")
