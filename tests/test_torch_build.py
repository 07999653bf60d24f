"""The port's kernel build (siss_tpu_torch.ops.build), checked from the
sources as text, so without nvcc or a card: every CUDA source is compiled,
and every C entry point gets a ctypes signature that matches its C
parameters (ctypes would otherwise pass each pointer as a 32-bit int)."""

import ctypes
import re

import pytest

from siss_tpu_torch.ops import build

_EXTERN = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _entry_points():
    """{name: [C parameter declarations]} of every extern "C" function."""
    found = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        for name, params in _EXTERN.findall(path.read_text()):
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


ENTRY_POINTS = _entry_points()


class _FakeLib:
    """Stands in for the ctypes.CDLL of the built library: records the
    signatures load() sets."""

    def __init__(self, path):
        self.functions = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.functions.setdefault(name, type("Fn", (), {})())


@pytest.fixture
def loaded(monkeypatch):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", lambda: "libfake.so")
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLib)
    return build.load()


def test_every_source_is_built():
    on_disk = {p.name for p in build.CSRC.glob("*.cu")}
    assert on_disk == set(build.SOURCES)
    assert len(build.SOURCES) == len(set(build.SOURCES))


def test_entry_points_found():
    assert {"siss_reduce", "siss_bwd", "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"} <= set(
        ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_load_sets_matching_argtypes(loaded, name):
    params = ENTRY_POINTS[name]
    fn = loaded.functions.get(name)
    assert fn is not None and hasattr(fn, "argtypes"), f"load() sets no argtypes for {name}"
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(params), (name, fn.argtypes, params)
    for ctype, param in zip(fn.argtypes, params):
        if "*" in param:
            assert ctype is ctypes.c_void_p or issubclass(ctype, ctypes._Pointer), (name, param)
        elif param.startswith("long long"):
            assert ctype is ctypes.c_longlong, (name, param)
        elif param.startswith("int"):
            assert ctype is ctypes.c_int, (name, param)
        elif param.startswith("float"):
            assert ctype is ctypes.c_float, (name, param)
        else:
            pytest.fail(f"{name}: no rule for the C parameter {param!r}")


def test_cached_build_keeps_its_log(tmp_path, monkeypatch):
    """A library already built is loaded as it is, with the nvcc output of
    the build that made it (ptxas' register report, which chip_smoke.py
    checks)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_info", dict(build.build_info))
    lib = tmp_path / f"libsiss_tpu_torch_kernels-{build._digest()}.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 111 registers")
    assert build.build() == lib
    assert build.build_info["seconds"] == 0.0
    assert "Used 111 registers" in build.build_info["log"]
