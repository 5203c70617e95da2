"""``paddle.regularizer`` (the port of ``paddle_tpu/regularizer.py``):
``L1Decay`` and ``L2Decay``.

Attached to a parameter (``ParamAttr(regularizer=...)``, stored as
``p.regularizer``), a regularizer's term ``reg(p)`` is added to the
gradient before the update and replaces the optimizer's own decay (the
reference's precedence).  A regularizer handed to an optimizer as
``weight_decay=`` is not read as one: the step calls ``float()`` on it and
raises ``TypeError``, as the reference does.
"""

from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __call__(self, param):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """``coeff * sign(p)``."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """``coeff * p``."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * param

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"
