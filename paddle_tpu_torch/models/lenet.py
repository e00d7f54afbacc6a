"""LeNet (counterpart of ``paddle_tpu/models/lenet.py``, BASELINE config
1, the reference's recognize_digits book test): the dygraph ``LeNet``
on the port's ``nn`` layers under the reference's names, and
``build_lenet_program``, the same net as a static program."""
from __future__ import annotations

from .. import nn
from .resnet import params_from_jax

__all__ = ["LeNet", "build_lenet_program", "params_from_jax"]


class LeNet(nn.Layer):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0),
            nn.ReLU(),
            nn.MaxPool2D(2, 2))
        self.fc = nn.Sequential(
            nn.Linear(400, 120),
            nn.Linear(120, 84),
            nn.Linear(84, num_classes))

    def forward(self, x):
        return self.fc(nn.functional.flatten(self.features(x), 1))


def build_lenet_program(batch_size: int = -1):
    """Static-graph LeNet (the fluid way): returns
    (main_program, startup_program, feeds, fetches). Needs static mode
    (``paddle_tpu_torch.enable_static()``)."""
    from ..fluid import framework, layers
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        img = layers.data("img", [batch_size, 1, 28, 28], "float32")
        label = layers.data("label", [batch_size, 1], "int64")
        conv1 = layers.conv2d(img, 6, 3, padding=1, act="relu")
        pool1 = layers.pool2d(conv1, 2, "max", 2)
        conv2 = layers.conv2d(pool1, 16, 5, act="relu")
        pool2 = layers.pool2d(conv2, 2, "max", 2)
        f = layers.flatten(pool2, axis=1)
        fc1 = layers.fc(f, 120, act="relu")
        fc2 = layers.fc(fc1, 84, act="relu")
        logits = layers.fc(fc2, 10)
        loss = layers.softmax_with_cross_entropy(logits, label)
        avg_loss = layers.mean(loss)
        acc = layers.accuracy(logits, label)
    return main, startup, {"img": img, "label": label}, \
        {"loss": avg_loss, "acc": acc, "logits": logits}
