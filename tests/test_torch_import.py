"""The PyTorch port stands alone: importing it, or running chip_smoke.py,
loads nothing of JAX or of the JAX package (the machine with the card has
no JAX)."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "sdrplusplusbrown_tpu_torch"
PY_FILES = sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))

_PROBE = """
import importlib, pkgutil, sys
import sdrplusplusbrown_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "sdrplusplusbrown_tpu"))
print(len([n for n in sys.modules if n.startswith(pkg.__name__)]), bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= len(PY_FILES) - 1, res.stdout


# the modules of the app's per-radio step, of the multi-mode bank, of
# channelizer64, of the serving path (the app, its entry point, the
# control plane, the pump and the sink layer), of RDS and the Radio's
# loops (the PLL, Costas, M&M, the RDS demod) and of the network path
# (zstd, the protocol, the compression, the host and device EFFT, the
# stream server and client, rigctl, the IQ exporter, the device feed)
# and the app's scanner, frequency manager, recorder and scheduler,
# imported with jax, jaxlib and the JAX package blocked (an import of
# any of them raises ImportError)
_STEP_MODULES = ["ops.fir_kernel", "ops.fir", "ops.resampler", "ops.demod",
                 "ops.wfm", "ops.wfm_kernel", "ops.fft_kernel",
                 "ops.spectrum", "models.radio", "models.iq_frontend",
                 "convert", "ops.agc", "ops.recurrence",
                 "ops.fused_frontend", "ops.plane_frontend",
                 "models.radio_bank", "ops.channelizer",
                 "ops.channelizer_kernel", "models.rx_vfo",
                 "ops.demod_kernel", "app", "__main__",
                 "server.http_server", "runtime.pump", "runtime.sink",
                 "runtime.routing", "runtime.migrate", "models.waterfall",
                 "io.wav", "io.file_source", "io.recorder", "utils.config",
                 "utils.flog", "utils.event", "utils.metrics", "ops.pll",
                 "ops.costas", "ops.clock_recovery", "models.rds",
                 "utils.zstd", "server.protocol", "ops.compression",
                 "ops.efft", "ops.efft_device", "server.stream_server",
                 "server.stream_client", "server.rigctl",
                 "server.rigctl_client", "modules", "modules.iq_exporter",
                 "io.feed", "modules.scanner", "modules.frequency_manager",
                 "modules.recorder_module", "modules.scheduler"]
_BLOCKED = """
import importlib, sys
for name in ("jax", "jaxlib", "sdrplusplusbrown_tpu"):
    sys.modules[name] = None
for m in {mods!r}:
    importlib.import_module("sdrplusplusbrown_tpu_torch." + m)
print("ok")
"""


def test_step_modules_import_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c",
                          _BLOCKED.format(mods=_STEP_MODULES)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr


@pytest.mark.parametrize("path", PY_FILES)
def test_no_jax_import_statement(path):
    src = (REPO / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax\w*|sdrplusplusbrown_tpu)\b",
                     src, re.M)
    assert not bad, (path, bad)


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax\w*|sdrplusplusbrown_tpu)\b",
                     src, re.M)
    assert not bad, bad
    assert "sdrplusplusbrown_tpu_torch" in src


def test_chip_smoke_fails_without_cuda():
    """Without a card the script exits nonzero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
