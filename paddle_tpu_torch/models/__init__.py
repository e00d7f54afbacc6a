"""Models of the port: GPT, BERT, wide&deep and the vision zoo (ResNet,
VGG, MobileNet, LeNet)."""
from .wide_deep import (WideDeepConfig, WideDeepTrainStep,
                        init_widedeep_params, widedeep_forward,
                        widedeep_loss)

__all__ = ["WideDeepConfig", "WideDeepTrainStep", "init_widedeep_params",
           "widedeep_forward", "widedeep_loss"]
