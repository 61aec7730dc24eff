"""The installed port has every subpackage and every file its builds read.

``setup.py`` is run with ``setuptools.setup`` replaced by a recorder, so
nothing is built. Its torch package list must name every directory of
``ngsamg_tpu_torch/`` that holds an ``__init__.py``, and its
``package_data`` must match every file that the CUDA build
(``ops/cuda_lib.py``: the ``csrc`` sources and headers) and the native build
(``native/build.py``: ``kernels.cpp``) read. The sparse formats and the
smoothers' core import no layer above them, at any level of the module:
every operator and smoother applies itself, so nothing there dispatches
to the classes of the transfers, the sharded solve or the cycle.
"""

import ast
import fnmatch
import os
import runpy

import pytest
import setuptools

from ngsamg_tpu_torch.native import build as native_build
from ngsamg_tpu_torch.ops import cuda_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ngsamg_tpu_torch")


@pytest.fixture(scope="module")
def setup_kwargs():
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(setuptools, "setup", lambda **kw: got.update(kw))
        mp.chdir(ROOT)
        runpy.run_path(os.path.join(ROOT, "setup.py"))
    return got


def test_every_subpackage_is_listed(setup_kwargs):
    found = {
        os.path.relpath(d, ROOT).replace(os.sep, ".")
        for d, _dirs, files in os.walk(PKG)
        if "__init__.py" in files
    }
    listed = {p for p in setup_kwargs["packages"]
              if p.split(".")[0] == "ngsamg_tpu_torch"}
    assert found == listed
    assert {"ngsamg_tpu_torch.native", "ngsamg_tpu_torch.parallel"} <= listed


def test_package_data_covers_what_the_builds_read(setup_kwargs):
    patterns = setup_kwargs["package_data"]["ngsamg_tpu_torch"]
    read = [*cuda_lib._sources(), *cuda_lib._headers(), native_build.SOURCE]
    assert any(p.suffix == ".cuh" for p in read)
    for path in read:
        rel = os.path.relpath(path, PKG).replace(os.sep, "/")
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel


_ABOVE = ("ngsamg_tpu_torch.solve", "ngsamg_tpu_torch.parallel",
          "ngsamg_tpu_torch.transfer.lattice_transfer")


def _imported(path):
    """Every module an import statement anywhere in ``path`` names: the
    module itself and, for ``from M import a``, ``M.a`` (a submodule, if
    ``a`` is one)."""
    mod = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    package = mod.split(".")[:-1]
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level \
                else []
            m = ".".join(base + ([node.module] if node.module else []))
            names.add(m)
            names.update(f"{m}.{a.name}" for a in node.names)
    return names


@pytest.mark.parametrize("rel,banned", [
    ("sparse/formats.py", _ABOVE),
    ("sparse/bell.py", _ABOVE),
    ("smoothers/core.py", _ABOVE + ("ngsamg_tpu_torch.smoothers.hiptmair",
                                    "ngsamg_tpu_torch.smoothers.block")),
])
def test_lower_layers_import_nothing_above_them(rel, banned):
    names = _imported(os.path.join(PKG, rel))
    # each imports its kernels: the walk resolves relative imports
    assert "ngsamg_tpu_torch.ops" in names
    up = sorted(n for n in names for b in banned
                if n == b or n.startswith(b + "."))
    assert not up, (rel, up)
