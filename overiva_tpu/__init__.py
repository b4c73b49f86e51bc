"""Former import name of :mod:`overiva_jax`, kept so existing code runs.

Importing this package, or any submodule under it, returns the very same
module objects as ``overiva_jax`` (no second copy of any module, so jit
caches and registries are shared) and emits a ``DeprecationWarning``. The
former native-RIR switch, this package's name in upper case followed by
``_NATIVE``, is read as ``OVERIVA_JAX_NATIVE`` when that is not set.
"""

import importlib
import importlib.abc
import importlib.util
import os
import sys
import warnings

_NEW = "overiva_jax"
_OLD = __name__

_old_switch = _OLD.upper() + "_NATIVE"
if _old_switch in os.environ:
    os.environ.setdefault("OVERIVA_JAX_NATIVE", os.environ[_old_switch])


class _Forward(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.a.b`` to the module ``overiva_jax.a.b``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import machinery stamped the alias spec on the real module;
        # give it back its own
        module.__spec__ = module.__spec__.loader_state


if not any(isinstance(f, _Forward) for f in sys.meta_path):
    sys.meta_path.insert(0, _Forward())

warnings.warn(
    f"the package {_OLD!r} is now {_NEW!r}; import {_NEW} instead",
    DeprecationWarning,
    stacklevel=2,
)

sys.modules[_OLD] = importlib.import_module(_NEW)
