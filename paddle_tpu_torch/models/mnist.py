"""The MNIST nets (the counterpart of ``paddle_tpu/models/mnist.py``):
the LeNet-style CNN and the MLP."""

from .. import layers, nets

__all__ = ["cnn_model", "mlp_model"]


def cnn_model(data, class_dim=10):
    """Two 5x5 conv + 2x2 max-pool blocks (20 and 50 filters, relu),
    then a softmax fc."""
    conv_pool_1 = nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(input=conv_pool_2, size=class_dim, act="softmax")


def mlp_model(data, class_dim=10, hidden=(128, 64)):
    x = data
    for h in hidden:
        x = layers.fc(x, size=h, act="relu")
    return layers.fc(x, size=class_dim, act="softmax")
