"""Launchers of the port: the multi-process runtime
(:mod:`repro_torch.launch.multiprocess`), the training CLI
(:mod:`repro_torch.launch.train`) and the shape-only dry run of the
registry cells on the production meshes (:mod:`repro_torch.launch.mesh`,
:mod:`repro_torch.launch.collective_census`,
:mod:`repro_torch.launch.input_specs`, :mod:`repro_torch.launch.dryrun`),
loaded on first use so that importing this package starts nothing and sets
no flags."""
import importlib

__all__ = ["multiprocess", "train", "mesh", "collective_census", "input_specs",
           "dryrun"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
