"""PyTorch/CUDA port of the Graph500 reproduction in ``repro``.

The single-device BFS path: Kronecker edge list -> symmetric CSR -> degree
sort (T2a) -> dense heavy core (T2b) -> the bitmap-resident,
direction-optimizing engine (T1) -> spec validation -> harmonic-mean TEPS.
Its two kernels, ``frontier_update`` and ``core_spmv``, are hand-written
CUDA C++ for Hopper (``kernels/csrc``).  The xDeepFM serving path
(``models.recsys``, ``train.train_step``) runs its CIN layers through the
hand-written ``cin_layer`` kernel, and ``kernels.ops.multi_source_spmv``
advances many BFS frontiers over the heavy core with the ``spmv_mxu``
kernel.  Entry points run on the card unless the caller passes
``device="cpu"``.  The package imports neither ``jax`` nor anything of
``repro``.
"""
from repro_torch import core, kernels

__all__ = ["core", "kernels"]
