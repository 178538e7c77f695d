"""ResNet-50/101/152 and the CIFAR-10 ResNet (the counterpart of
``paddle_tpu/models/resnet.py``): conv_bn_layer + bottleneck or basic
block stacks, on the conv, pool and batch_norm lowerings (cuDNN on the
card; no hand-written kernel is on this path)."""

from .. import framework, layers, optimizer as opt_mod

__all__ = ["resnet_imagenet", "resnet_cifar10", "resnet50", "ResNetConfig",
           "build_resnet_train_program"]


class ResNetConfig:
    depth_blocks = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None, is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, None, is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out * 4, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, None, is_test)
    return layers.elementwise_add(short, conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_test=False):
    res_out = block_func(input, ch_out, stride, is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test)
    return res_out


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    cfg = ResNetConfig.depth_blocks[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2, pool_padding=1,
                          pool_type="max")
    res1 = layer_warp(bottleneck, pool1, 64, cfg[0], 1, is_test)
    res2 = layer_warp(bottleneck, res1, 128, cfg[1], 2, is_test)
    res3 = layer_warp(bottleneck, res2, 256, cfg[2], 2, is_test)
    res4 = layer_warp(bottleneck, res3, 512, cfg[3], 2, is_test)
    pool2 = layers.pool2d(res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet50(input, class_dim=1000, is_test=False):
    return resnet_imagenet(input, class_dim, 50, is_test)


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test)
    pool = layers.pool2d(res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def build_resnet_train_program(batch_size=None, image_shape=(3, 224, 224),
                               class_dim=1000, depth=50, lr=0.1,
                               optimizer="momentum", dtype="float32",
                               use_bf16=False, use_nhwc=False,
                               use_reader_op=False, reader_capacity=8):
    """(main_program, startup_program, feeds, fetches) of a training
    step, as the reference builds them: feeds "image" and "label",
    fetches [avg_cost, acc], Momentum 0.9 (or SGD) at `lr`.  use_nhwc
    runs the conv trunk channels-last (``rewrite_nhwc``, before the
    optimizer so that the grads run through its transposes).  use_bf16
    (the AMP pass, ROADMAP A3) and use_reader_op (py_reader, ROADMAP A9)
    are not ported yet and raise."""
    if use_bf16:
        raise NotImplementedError("build_resnet_train_program(use_bf16=True)"
                                  ": the bf16 AMP pass is not ported yet "
                                  "(ROADMAP A3)")
    if use_reader_op:
        raise NotImplementedError("build_resnet_train_program(use_reader_op="
                                  "True): py_reader is not ported yet "
                                  "(ROADMAP A9)")
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        img = layers.data("image", shape=list(image_shape), dtype=dtype)
        label = layers.data("label", shape=[1], dtype="int64")
        predict = resnet_imagenet(img, class_dim, depth)
        cost = layers.cross_entropy(input=predict, label=label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(input=predict, label=label)
        if use_nhwc:
            from ..transpiler.layout_transpiler import rewrite_nhwc

            rewrite_nhwc(main)
        # the reference's maybe_remat(main, avg_cost) changes nothing
        # unless FLAGS_hbm_budget_bytes is set, and the port has no flags
        # module yet (ROADMAP A1): the call is left out
        if optimizer == "momentum":
            opt = opt_mod.Momentum(learning_rate=lr, momentum=0.9)
        else:
            opt = opt_mod.SGD(learning_rate=lr)
        opt.minimize(avg_cost)
    return main, startup, ["image", "label"], [avg_cost, acc]
