"""Launchers of the port: the multi-process runtime
(:mod:`repro_torch.launch.multiprocess`), loaded on first use so that
importing this package starts nothing."""
import importlib

__all__ = ["multiprocess"]


def __getattr__(name):
    if name == "multiprocess":
        return importlib.import_module(f"{__name__}.multiprocess")
    raise AttributeError(name)
