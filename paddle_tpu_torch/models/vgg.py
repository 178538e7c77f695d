"""VGG-16 and VGG-19 (the counterpart of ``paddle_tpu/models/vgg.py``):
conv groups with batch norm, then the fc head."""

from .. import layers, nets

__all__ = ["vgg16", "vgg19"]


def _vgg(input, nums, class_dim, is_test=False):
    def conv_block(x, num_filter, groups):
        return nets.img_conv_group(
            input=x, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True, pool_type="max")

    conv1 = conv_block(input, 64, nums[0])
    conv2 = conv_block(conv1, 128, nums[1])
    conv3 = conv_block(conv2, 256, nums[2])
    conv4 = conv_block(conv3, 512, nums[3])
    conv5 = conv_block(conv4, 512, nums[4])

    fc1 = layers.fc(input=conv5, size=4096, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test,
                           data_layout="NHWC")
    drop = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop, size=4096, act=None)
    return layers.fc(input=fc2, size=class_dim, act="softmax")


def vgg16(input, class_dim=1000, is_test=False):
    return _vgg(input, [2, 2, 3, 3, 3], class_dim, is_test)


def vgg19(input, class_dim=1000, is_test=False):
    return _vgg(input, [2, 2, 4, 4, 4], class_dim, is_test)
