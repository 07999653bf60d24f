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
SOURCES = ("siss_reduce.cu", "siss_bwd.cu", "flash_fwd.cu", "flash_bwd.cu", "flash_fwd_sm90.cu",
           "flash_bwd_dkv_sm90.cu", "flash_bwd_dq_sm90.cu", "flash_fwd_tf32x3.cu",
           "flash_bwd_dkv_tf32x3.cu", "flash_bwd_dq_tf32x3.cu", "launch_floor.cu")
# --fmad=false: no multiply-add contraction, so each elementwise step rounds
# as PyTorch's op-by-op plain versions do; the SISS backward kernel then
# matches its plain version bit for bit, and the 3xTF32 kernels' softmax
# and dS steps round as their emulated models do. The 3xTF32 split (x - hi)
# is one exact subtraction, with or without it.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
#: What the last build did: seconds it took (0.0 when the library was
#: already built), nvcc's output, including ptxas' register report (kept
#: beside the library and read back when it was already built), and the
#: library's path.
build_info = {"seconds": None, "log": "", "path": None}


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
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        build_info.update(seconds=0.0, log=log, path=lib_path)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{Path(s).stem}-{os.getpid()}.o" for s in SOURCES]
    log = _run([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                for s, o in zip(SOURCES, objs)])
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    log += _run([[nvcc, "-shared", *map(str, objs), "-o", str(tmp)]])
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    for o in objs:
        o.unlink()
    build_info.update(seconds=time.perf_counter() - t0, log=log, path=lib_path)
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
        f, strides = ctypes.c_float, ctypes.POINTER(ll)
        lib.flash_fwd.argtypes = [p] * 5 + [i] * 6 + [strides, f, p]
        lib.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [strides, f, p]
        lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [strides, f, p]
        lib.empty_launches.argtypes = [i, p]
        for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq, lib.empty_launches):
            fn.restype = i
        _lib = lib
    return _lib
