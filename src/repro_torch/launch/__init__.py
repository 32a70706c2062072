"""Launchers of the port: the multi-process runtime
(:mod:`repro_torch.launch.multiprocess`) and the training CLI
(:mod:`repro_torch.launch.train`), loaded on first use so that importing
this package starts nothing."""
import importlib

__all__ = ["multiprocess", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
