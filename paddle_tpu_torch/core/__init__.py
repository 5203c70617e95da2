"""The framework core of the Paddle-API path: tensors, random state and
the autocast state (the port of ``paddle_tpu/core/``).  The reference's
tape (``core/autograd.py``) has no module here: PyTorch's autograd is its
counterpart (:mod:`paddle_tpu_torch.autograd`)."""
