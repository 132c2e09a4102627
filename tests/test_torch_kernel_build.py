"""The kernel libraries' names, on the CPU (nothing here runs nvcc).

A library is named by a digest of its source and of the shared headers
under ``csrc/``, so an edit to either gives a new name and a stale library
is never loaded; every header a source includes by quotes lies in
``csrc/``, where both the build and ``flash_q_probe.py`` find it.
"""

import re
import shutil

import pytest

from seldon_core_tpu_torch.ops import kernel_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    for path in kernel_build.CSRC.iterdir():
        shutil.copy(path, tmp_path / path.name)
    monkeypatch.setattr(kernel_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("name", kernel_build.KERNELS)
@pytest.mark.parametrize("edited", ["source", "header"])
def test_library_name_follows_its_source_and_the_shared_headers(csrc, name, edited):
    before = kernel_build.library_path(name)
    path = csrc / (f"{name}.cu" if edited == "source" else "hopper.cuh")
    path.write_text(path.read_text() + "\n// edited\n")
    after = kernel_build.library_path(name)
    assert after != before and after.parent == before.parent


@pytest.mark.parametrize("name", kernel_build.KERNELS)
def test_quoted_includes_lie_in_csrc(name):
    src = (kernel_build.CSRC / f"{name}.cu").read_text()
    included = re.findall(r'#include "([^"]+)"', src)
    assert included == ["hopper.cuh"]
    assert all((kernel_build.CSRC / header).is_file() for header in included)
