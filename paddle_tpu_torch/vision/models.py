"""The vision model zoo (counterpart of ``paddle_tpu/vision/models.py``):
LeNet, ResNet 18/34/50/101/152, VGG 11/13/16/19, MobileNet v1/v2, from
``paddle_tpu_torch.models``."""
from ..models.lenet import LeNet
from ..models.mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,
                                mobilenet_v2)
from ..models.resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                             resnet34, resnet50, resnet101, resnet152)
from ..models.vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "MobileNetV1", "MobileNetV2",
           "mobilenet_v1", "mobilenet_v2"]
