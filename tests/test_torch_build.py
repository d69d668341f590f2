"""The kernel library's build (``modem_tpu_torch/cuda.py``) on the CPU, with a
stand-in compiler: a build that fails raises the compilers' output, and the
same sources are not compiled again in that process, so that a run of many
kernel tests over sources that do not compile fails at once instead of
paying a full build per test."""

from __future__ import annotations

import stat

import pytest

from modem_tpu_torch import cuda


@pytest.fixture
def failing_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` that logs each call to ``calls.txt`` and fails; the build
    goes to a fresh directory. Returns the log's path."""
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho \"$@\" >> {calls}\n"
                    "echo 'error: deliberately refused'\nexit 1\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda, "_failed_builds", {})
    return calls


def test_failed_build_raises_the_compiler_output(failing_nvcc):
    with pytest.raises(RuntimeError, match="deliberately refused"):
        cuda.build_library()
    n_sources = len(list(cuda.CSRC.glob("*.cu")))
    assert len(failing_nvcc.read_text().splitlines()) == n_sources
    assert not list((cuda.BUILD_DIR).glob("*.so"))


@pytest.mark.parametrize("again", [1, 3])
def test_failed_build_is_not_compiled_again(failing_nvcc, again):
    with pytest.raises(RuntimeError):
        cuda.build_library()
    first = failing_nvcc.read_text()
    for _ in range(again):
        with pytest.raises(RuntimeError, match="deliberately refused"):
            cuda.build_library()
    assert failing_nvcc.read_text() == first
