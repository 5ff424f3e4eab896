"""Attribute-access config dict with recursive update.

Equivalent in role to the reference's addict ``Dict`` (`_util/util_v1.py:47-50`)
and ``dnnlib.EasyDict`` (`src/dnnlib/util.py:42`): nested configs built by
attribute access, merged by recursive ``update``.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping


class Dict(dict):
    """dict with attribute access and recursive merge semantics."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for a in args:
            if a is None:
                continue
            self._merge(a)
        if kwargs:
            self._merge(kwargs)

    def _merge(self, other: Mapping) -> None:
        for k, v in dict(other).items():
            self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v: Any) -> Any:
        if isinstance(v, Dict):
            return v
        if isinstance(v, dict):
            return Dict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Dict._wrap(x) for x in v)
        return v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            if name.startswith("__"):  # don't fabricate dunder attributes
                raise AttributeError(name) from None
            # addict-style autonesting: d.a.b = 1 creates intermediate Dicts
            child = Dict()
            self[name] = child
            return child

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def update(self, other=None, **kwargs):  # type: ignore[override]
        """Recursive update: nested dicts merge instead of replace."""
        if other is not None:
            self._recursive_update(self, other)
        if kwargs:
            self._recursive_update(self, kwargs)
        return self

    @classmethod
    def _recursive_update(cls, dst: dict, src: Mapping) -> None:
        for k, v in dict(src).items():
            if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
                cls._recursive_update(dst[k], v)
            else:
                dst[k] = cls._wrap(v)

    def __deepcopy__(self, memo):
        return Dict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def copy(self) -> "Dict":
        return Dict(self)


EasyDict = Dict


def construct_class_by_name(class_name: str, **kwargs):
    """String-to-class factory (role of `src/dnnlib/util.py:303-306`)."""
    module_name, _, attr = class_name.rpartition(".")
    import importlib

    mod = importlib.import_module(module_name)
    return getattr(mod, attr)(**kwargs)
