#!/usr/bin/env python3
"""Phase 26 (b)'s threaded int8 client of ``chip_smoke.py`` with the IQ
stream server in the client's own interpreter against the server as a
process of its own, on one NVIDIA GPU:

    python3 scripts/net_rt_ab.py [--rounds N]

It writes phase 19's 2.4 MS/s capture, warms the kernels with four
manual blocks, then runs ``chip_smoke.net_threaded`` ``--rounds`` times
each way, alternated (in process, own process, ...): the app of phase 19
on an ``sdrpp_server`` source in int8 with its pump thread for 5 s, each
block's time from its last samples' arrival to its end through a sync
(p50 / p90 / p99 against the block's 50 ms).  A run over the bar prints
its failure and the script goes on; it exits 0.  Needs CUDA; imports no
JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as smoke
    if not torch.cuda.is_available():
        print("net_rt_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="net_rt_ab_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        smoke.served_capture(cap)
        warm = smoke.new_app(os.path.join(tmp, "warm"),
                             smoke.served_config(cap, "manual"), dev)
        try:
            smoke.run_net_app(warm, 4, torch.cuda.synchronize)
        finally:
            warm.shutdown()
        for r in range(a.rounds):
            for in_process in (True, False):
                try:
                    smoke.net_threaded(dev, card, tmp, cap, in_process)
                except RuntimeError as e:
                    print(f"net_rt_ab round {r + 1}: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
