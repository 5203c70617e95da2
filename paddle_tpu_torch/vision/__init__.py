"""The port of ``paddle_tpu.vision``: so far ``models`` (the ResNet
family), whose names it re-exports as the reference's ``vision`` does."""

from . import models  # noqa: F401
from .models import (BasicBlock, BottleneckBlock, ResNet, resnet18,  # noqa
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
