"""The installed port has every subpackage and every file its builds read.

``setup.py`` is run with ``setuptools.setup`` replaced by a recorder, so
nothing is built. Its torch package list must name every directory of
``ngsamg_tpu_torch/`` that holds an ``__init__.py``, and its
``package_data`` must match every file that the CUDA build
(``ops/cuda_lib.py``: the ``csrc`` sources and headers) and the native build
(``native/build.py``: ``kernels.cpp``) read.
"""

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
