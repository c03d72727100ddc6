"""The CUDA build's cache key (``repro_torch.kernels.build.library_path``):
a library is rebuilt when its source or a ``csrc/`` header that the source
includes changes, and not for a header it does not include. The card's
architecture is monkeypatched, so this runs on the CPU."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as trwkv  # noqa: E402


@pytest.fixture
def sources(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_arch", lambda: "90a")
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "ptx.cuh"\nint f() {}\n')
    (tmp_path / "ptx.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "unused.cuh").write_text("// v1\n")
    return tmp_path


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True), ("ptx.cuh", True), ("inner.cuh", True),
    ("unused.cuh", False)])
def test_library_path_follows_the_source_and_its_headers(sources, edited,
                                                         rebuilds):
    before = build.library_path(sources / "k.cu")
    assert before.name.startswith("k_sm90a_")
    with open(sources / edited, "a") as f:
        f.write("// edited\n")
    after = build.library_path(sources / "k.cu")
    assert (after != before) == rebuilds


def test_dependencies_of_the_port_sources():
    names = [p.name for p in build.dependencies(tflash.SOURCE)]
    assert names == ["flash_attention.cu", "warp_mma.cuh"]
    assert [p.name for p in build.dependencies(trwkv.SOURCE)] == [
        "rwkv6_chunk.cu", "warp_mma.cuh"]
