"""paddle_tpu_torch.incubate — the fleet 1.x namespace (counterpart of
``paddle_tpu/incubate/``): ``incubate.fleet``'s role makers and the
transpiler-mode parameter-server fleet. ``incubate.checkpoint`` and
``incubate.complex`` wait for ROADMAP.md A, item 13."""
from . import fleet  # noqa: F401
