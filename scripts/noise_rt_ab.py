#!/usr/bin/env python3
"""Phase 23's real-time run of ``chip_smoke.py`` on the port of one tree,
on one NVIDIA GPU, for a parent / change comparison of the noise path:

    python3 scripts/noise_rt_ab.py [--tree DIR]

It writes phase 19's 2.4 MS/s capture and runs
``chip_smoke.noise_in_real_time`` (this tree's measurement code, whatever
``--tree`` is) on the package of ``--tree DIR`` (another checkout, such
as a parent commit unpacked with ``git archive``): the app with ``ifnr:
true``, the noise blanker on the WFM radio and the FM IF filter on the
NFM radio, its pump thread for 10 s (block wall percentiles, rtFactor),
a profiler window of 20 blocks (device µs, launches and copies a block)
and the IF NR alone on one block; it prints ``noise_rt: ok`` or the
failure (the guard shed the IF NR, or the p99 block exceeded 50 ms) and
exits 0 either way.  Run it parent / change / change / parent in one
call.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "sdrplusplusbrown_tpu_torch"]:
        del sys.modules[name]
    import torch
    import sdrplusplusbrown_tpu_torch as pkg
    from sdrplusplusbrown_tpu_torch.kernels import _build
    if not torch.cuda.is_available():
        print("noise_rt_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"noise_rt: the package of {os.path.dirname(pkg.__file__)}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"noise_rt: build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="noise_rt_ab_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        smoke.served_capture(cap)
        try:
            smoke.noise_in_real_time(dev, card, tmp, cap)
            print("noise_rt: ok")
        except RuntimeError as e:
            print(f"noise_rt: failed: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
