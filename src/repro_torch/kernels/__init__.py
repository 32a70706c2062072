"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel module wraps one ``csrc/*.cu`` source; ``ref.py`` holds the
plain versions and ``ops.py`` the device-dispatched entry points.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
