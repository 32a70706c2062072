"""Training of the port: the xDeepFM train and serve steps, the optimizer
loop with checkpoints and resume, and elastic restore."""
from repro_torch.train import checkpoint, elastic, loop, train_step

__all__ = ["checkpoint", "elastic", "loop", "train_step"]
