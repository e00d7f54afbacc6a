"""LeNet as a static program (counterpart of
``paddle_tpu/models/lenet.py``: ``build_lenet_program``, BASELINE config
1, the reference's recognize_digits book test). The dygraph ``LeNet``
class waits for the port's ``nn.Conv2D`` and ``nn.MaxPool2D`` layers
(ROADMAP.md A, item 13)."""
from __future__ import annotations


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
