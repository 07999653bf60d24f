"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``) with nvcc.

The sources have a plain C interface and are bound with ``ctypes``, so a
build takes seconds rather than the minutes a source including PyTorch's
headers would. Each source compiles in its own ``nvcc`` process, all started
together, and the objects link into one shared library under
``build/siss_tpu_torch_kernels/`` at the repository root. The library's name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. Nothing builds at import time: the first
wrapper call on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "siss_tpu_torch_kernels"
SOURCES = ("siss_reduce.cu", "siss_bwd.cu")
# --fmad=false: no multiply-add contraction, so each elementwise step rounds
# as PyTorch's op-by-op plain versions do; the backward kernel then matches
# its plain version bit for bit. The kernels are bound by memory, not flops.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
#: What the last build did: seconds it took (0.0 when the library was
#: already built) and nvcc's output, including ptxas' register report.
build_info = {"seconds": None, "log": ""}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed "
                           "to build the siss_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:12]


def _run(cmds):
    """Run the commands in parallel; raise with their output if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            for other in procs:
                other.wait()
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n" + "\n".join(logs))
    return "\n".join(logs)


def build() -> Path:
    """Compile the kernels if this version of the sources is not built yet."""
    lib_path = BUILD_DIR / f"libsiss_tpu_torch_kernels-{_digest()}.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, log="")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{Path(s).stem}-{os.getpid()}.o" for s in SOURCES]
    log = _run([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                for s, o in zip(SOURCES, objs)])
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    log += _run([[nvcc, "-shared", *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    for o in objs:
        o.unlink()
    build_info.update(seconds=time.perf_counter() - t0, log=log)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.siss_reduce.argtypes = [p, p, p, p, p, p, p, p, i, ll, ll, i, i, i, p]
        lib.siss_reduce.restype = i
        lib.siss_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, ll, i, i, p]
        lib.siss_bwd.restype = i
        _lib = lib
    return _lib
