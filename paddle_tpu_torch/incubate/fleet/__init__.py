"""fleet 1.x incubate namespace (counterpart of
``paddle_tpu/incubate/fleet/``; reference python/paddle/fluid/incubate/
fleet/) — the transpiler-era PS API beside the 2.0 fleet in
paddle_tpu_torch.distributed.fleet."""
from . import base, parameter_server  # noqa: F401
