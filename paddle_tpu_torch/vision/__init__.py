"""The vision package of the port (counterpart of ``paddle_tpu/vision``),
as far as its model zoo: ``vision.models``."""
from . import models

__all__ = ["models"]
