"""Lazy package attributes: a package's ``__getattr__`` imports a
submodule, or a name from one, on first access, so that importing the
package stays light (no index family, no kernel wrapper, no CUDA context
until something is used)."""

from __future__ import annotations

import importlib
import importlib.util
import sys
from typing import Callable, Dict, Optional, Tuple


def attach(package: str, table: Dict[str, Tuple[str, Optional[str]]]
           ) -> Tuple[Callable, Callable]:
    """``(__getattr__, __dir__)`` for ``package``. ``table`` maps a public
    name to ``(submodule, attribute)``: the submodule itself when the
    attribute is None. Any other submodule resolves by its own name, as an
    eagerly imported one would."""

    def __getattr__(name: str):
        if name in table:
            sub, attr = table[name]
            mod = importlib.import_module(f"{package}.{sub}")
            value = mod if attr is None else getattr(mod, attr)
        elif importlib.util.find_spec(f"{package}.{name}") is not None:
            value = importlib.import_module(f"{package}.{name}")
        else:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        setattr(sys.modules[package], name, value)
        return value

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(table))

    return __getattr__, __dir__
