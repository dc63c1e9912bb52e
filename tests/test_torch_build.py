"""The ctypes argument types of every CUDA entry point
(``kernels/_build.py:SIGNATURES``) against its ``extern "C"`` declaration
in ``csrc/*.cu``: the same count and kinds (pointer, int, float), the
stream last.  ctypes cannot check a C declaration, so a parameter added
to or dropped from a kernel's entry point without the table surfaces
only as a failed call on the card."""

import ctypes
import pathlib
import re

import pytest

from sdrplusplusbrown_tpu_torch.kernels import _build

CSRC = pathlib.Path(_build.CSRC)
DECL = re.compile(r'extern "C" int (sdr_\w+)\(([^)]*)\)', re.S)


def _declarations() -> dict:
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in DECL.findall(src.read_text()):
            out[name] = [" ".join(p.split()) for p in params.split(",")]
    return out


def _kind(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[
        param.removeprefix("const ").split()[0]]


def test_every_entry_point_has_a_signature():
    assert set(_declarations()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_source(name):
    params = _declarations()[name]
    assert params[-1] == "cudaStream_t stream", params[-1]
    assert [_kind(p) for p in params[:-1]] == _build.SIGNATURES[name]


def test_first_launches_from_two_threads_build_once(monkeypatch):
    """``lib()`` from two threads at once: one build (its object files
    are named by the process id, so two would compile over each other)
    and both threads get the one library."""
    import threading
    import time
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return "libsdrkernels_fake.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_LIB", [])
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.lib()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert len(got) == 2 and got[0] is got[1]
