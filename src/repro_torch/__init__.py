"""PyTorch/CUDA port of the Graph500 reproduction in ``repro``.

The single-device BFS path: Kronecker edge list -> symmetric CSR -> degree
sort (T2a) -> dense heavy core (T2b) -> the bitmap-resident,
direction-optimizing engine (T1) -> spec validation -> harmonic-mean TEPS.
Its two kernels, ``frontier_update`` and ``core_spmv``, are hand-written
CUDA C++ for Hopper (``kernels/csrc``).  The reference and legacy engines
(the lower rungs of the paper's Fig. 18 ladder; the legacy one calls
``core_spmv`` too) and the δ-stepping SSSP kernel run on the same plan and
validation layers.  The xDeepFM serving path
(``models.recsys``, ``train.train_step``) runs its CIN layers through the
hand-written ``cin_layer`` kernel, and ``kernels.ops.multi_source_spmv``
advances many BFS frontiers over the heavy core with the ``spmv_mxu``
kernel.  Checked execution (``core.faults``: deterministic fault
injection; ``CompiledBFS.run``'s retry -> fallback -> quarantine) and the
BFS/SSSP serving engine (``serve``: coalescer, hot-root cache, checked
batches; ``core.pipeline.serve``) run on the same plans.  The plan
auto-tuner (``core.tune``) sweeps the plan space on the card, accepts a
candidate only when its parents equal the single-device plan's bit for
bit, and persists the winner per (scale, devices, backend) in
``TUNED_PLANS_torch.json``, which the ``pre-g500-tuned`` rung and the
serving engine read; ``comms.topology`` plans the monitor groups and the
(group, member) mesh split.  The multi-device layouts (root-parallel,
vertex-sharded with the T3 monitor exchange of ``comms.hierarchical``, and
both composed) run on ``comms.mesh`` meshes: virtual meshes of several
shards on one device, one shard per card, or one process per monitor group
over ``torch.distributed`` (``launch.multiprocess``); their sharded engines
launch both BFS kernels on every shard.  The tuner also sweeps a virtual
mesh of N shards of one device (``sweep(devices=N)``), and the serving
engine serves on a given mesh.  xDeepFM trains on the card
(``optim``: AdamW, SGD, the schedules and gradient compression;
``train``: the train step, checkpoints in the JAX package's format, the
resumable loop, elastic restore; ``launch.train``), and data-parallel
steps sum their gradients with the T3 monitor psum of
``comms.hierarchical``.  The LM stack (``models.layers``, ``models.moe``,
``models.transformer``; five archs in ``configs.lm_archs``) prefills,
decodes greedily over a KV cache and trains, with its MoE layers
dispatched densely, over a mesh's ``model`` shards, or through the T3
monitor all-to-all; its bf16 activations are XLA's op chains, forward and
backward.  The GNN stack (``models.gnn``: GAT, GraphSAGE full-graph and
sampled blocks, DimeNet, EquiformerV2; ``models.gnn_dist``: the
owner-partitioned SAGE step over the T3 monitor all-gather) trains on the
same optimizers.  The dry run (``launch.dryrun``) runs every registry
cell's step shape-only on ``meta`` tensors, counts its FLOPs, bytes and
collectives, and ranks the H100 roofline terms on 256- and 512-GPU meshes.
Entry points run on the card unless the caller passes ``device="cpu"``.
The package imports neither ``jax`` nor anything of ``repro``.
"""
from repro_torch import comms, core, kernels, launch, optim, train

__all__ = ["comms", "core", "kernels", "launch", "optim", "train"]
