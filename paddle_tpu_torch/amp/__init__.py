"""Mixed precision of the port (counterpart of ``paddle_tpu/amp``)."""
from .auto_cast import (amp_guard, amp_level, auto_cast, autocast_inputs,
                        black_list, white_list)

__all__ = ["amp_guard", "auto_cast", "amp_level", "autocast_inputs",
           "white_list", "black_list"]
