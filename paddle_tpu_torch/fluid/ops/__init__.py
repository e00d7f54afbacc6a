"""The fluid op library of the port (counterpart of
``paddle_tpu/fluid/ops/``): importing this package registers the ops the
ported programs use; ``optimizer_ops`` also holds the plain update
functions the train steps call."""
from . import (math_ops, nn_ops, tensor_ops, random_ops, metric_ops,
               optimizer_ops, sequence_ops, structured_loss_ops,
               misc_ops, tail_ops)  # noqa: F401
