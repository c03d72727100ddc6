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
    """Each source with the headers it includes, directly or through
    another: the flash kernels' self-attention and wide-head sources share
    ``flash_common.cuh`` (which includes ``mma3.cuh``), so an edit of
    either header rebuilds both libraries."""
    for source in (tflash.SOURCE, tflash.WIDE_SOURCE):
        assert [p.name for p in build.dependencies(source)] == [
            source.name, "warp_mma.cuh", "flash_common.cuh", "mma3.cuh"]
    for source in (trwkv.SOURCE, trwkv.BWD_SOURCE):
        assert [p.name for p in build.dependencies(source)] == [
            source.name, "warp_mma.cuh", "mma3.cuh", "wkv6_chunk.cuh"]
