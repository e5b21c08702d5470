"""pytest plugin: answers every import of jax, jaxlib and the JAX package
``repro`` with an inert stub, so that a test module which imports both
packages can run its card-only tests (which touch only ``repro_torch``)
on a machine without JAX.  Nothing of JAX or of ``repro`` runs; a test
that calls into them fails.  On a CUDA machine:

    PYTHONPATH=src:tests python -m pytest -p card_stub_jax \
        -p no:cacheprovider -q tests/test_torch_moe.py -k on_card
"""
import importlib.abc
import importlib.machinery
import sys
import types
from unittest import mock

ROOTS = ("jax", "jaxlib", "repro")


class _Stub(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        value = mock.MagicMock(name=f"{self.__name__}.{name}")
        setattr(self, name, value)
        return value


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in ROOTS:
            return importlib.machinery.ModuleSpec(fullname, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        mod = _Stub(spec.name)
        mod.__path__ = []
        return mod

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, _Finder())
