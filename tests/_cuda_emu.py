"""Build a CUDA source of ``src/repro_torch/kernels/csrc/`` for the host
with ``g++`` against the stand-in in ``tests/cuda_emu`` (one thread per
CUDA thread, a barrier for ``__syncthreads``), and bind its C interface
with the same ``ctypes`` signatures as on the card.

The kernels must keep two lines as they are, which the build rewrites:
the launch ``Kernel<<<grid, NT, bytes, stream>>>(args...);`` (``NT`` may
be a template parameter of the launching function) and the shared-memory
declaration ``extern __shared__ __align__(16) float smem[];`` (a kernel
that works in bf16 casts ``smem``).

Headers: ``tests/cuda_emu`` comes first on the include path, then the
source's own directory. So ``tests/cuda_emu/warp_mma.cuh``, the
warp-collective stand-ins of the tensor-core and ``cp.async``
instructions, takes the place of ``csrc/warp_mma.cuh`` (inline PTX), and
any other header of ``csrc/`` is the source's own. The built library also
exports ``emu_block_threads()`` (threads per block of the last launch) and,
where the source includes ``warp_mma.cuh``, ``emu_mma_calls()`` (the
``mma`` calls of warp 0 so far), which tell the tests which kernel ran.
"""
import ctypes
import pathlib
import shutil
import subprocess

import pytest

EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
LAUNCH = "Kernel<<<grid, NT, bytes, stream>>>(args...);"
SHARED = "extern __shared__ __align__(16) float smem[];"


def build(source: pathlib.Path, signatures, out: pathlib.Path) -> ctypes.CDLL:
    """``source`` compiled for the host into ``out``, its functions bound
    (``restype`` int); skips the calling test without ``g++``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host stand-in of the kernels")
    src = source.read_text()
    assert LAUNCH in src and SHARED in src, "kernel source layout changed"
    src = src.replace(LAUNCH, "emu_launch(Kernel, grid, NT, bytes, stream, "
                              "args...);")
    src = src.replace(SHARED, "float* smem = emu_smem;")
    cpp = out / f"{source.stem}_emu.cpp"
    cpp.write_text(src)
    lib = out / f"lib{source.stem}_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-fno-strict-aliasing",
                    "-pthread", "-shared", "-fPIC", "-w", f"-I{EMU}",
                    f"-I{source.parent}", str(cpp), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in signatures.items():
        getattr(cdll, name).argtypes = argtypes
        getattr(cdll, name).restype = ctypes.c_int
    return cdll
