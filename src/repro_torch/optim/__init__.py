"""Optimizers, schedules and gradient compression of the port (the
counterpart of ``repro.optim``)."""
from repro_torch.optim.optimizer import AdamW, SGD, constant, cosine, wsd
from repro_torch.optim import compression

__all__ = ["AdamW", "SGD", "constant", "cosine", "wsd", "compression"]
