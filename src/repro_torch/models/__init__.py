"""Model code of the port: ``common``, ``ssm``, ``rglru``, ``attention``,
``moe``, ``transformer``, ``encdec``, ``zoo``, ``convert``.  Submodules load on first use;
importing the package loads none of them and builds nothing."""
import importlib

_SUBMODULES = ("attention", "common", "convert", "encdec", "moe", "rglru",
               "ssm", "transformer", "zoo")
_EXPORTS = {"Model": "zoo", "count_params": "zoo"}

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                       name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
