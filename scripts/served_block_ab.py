#!/usr/bin/env python3
"""Device µs and kernel launches a served block, one tree at a time, for a
parent / change comparison on one NVIDIA GPU:

    python3 scripts/served_block_ab.py [--tree DIR] [--blocks N]

Builds ``chip_smoke.py``'s served apps in manual pump mode: phase 21's
(the DC blocker, a WFM, an NFM and a squelched NFM radio on 120 000-sample
blocks of the served capture), phase 23's (that capture with ``ifnr``,
the noise blanker on W and the FM IF filter on N, measured once the IF NR
is primed) and phase 25's (two WFM radios decoding RDS on 480 000-sample
blocks).  After warm-up blocks it profiles N blocks
(``chip_smoke.call_profile`` around ``pump_step(1)``: the device time of
the kernels and copies the window saw, and the kernel launches, a block)
and prints them with the largest kernels.  The captures loop, so every
block is a real one; the real-time guard's clock stands still, as in
phase 23's card run.  Unlike the threaded pump's window (phases 21, 23,
25), whose 20 blocks can catch a block more or less of launches at its
edges, every profiled call here is one whole block.  ``--tree DIR``
imports the port from another checkout (a parent commit unpacked with
``git archive``); run it parent / change / change / parent in one call.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_blocks(smoke, app, warm: int, blocks: int, label: str,
                   card: str) -> None:
    """``warm`` blocks, then ``blocks`` profiled ones: device µs, launches
    and the largest kernels a block."""
    import torch
    for _ in range(warm):
        if app.pump_step(1) != 1:
            raise RuntimeError(f"{label}: the pump stopped")
    torch.cuda.synchronize()
    by_kernel = {}
    us, n = smoke.call_profile(lambda: app.pump_step(1), reps=blocks,
                               by_kernel=by_kernel)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label}: {us:.1f} us device and {n} kernel launches a block "
          f"({blocks} blocks of {app.pump_block_len}); largest: "
          + ", ".join(f"{k} {v:.1f}" for k, v in top) + f" [{card}]",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--blocks", type=int, default=20)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("served_block_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    dev = torch.device("cuda", 0)
    tree = os.path.relpath(os.path.abspath(a.tree), ROOT)
    with tempfile.TemporaryDirectory(prefix="served_block_ab_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        smoke.served_capture(cap)
        rds = os.path.join(tmp, "rds", "baseband_100000000Hz_10-00-00_"
                                       "01-01-2024.wav")
        os.makedirs(os.path.dirname(rds))
        write_wav(rds, smoke.rds_wideband(int(smoke.FS * smoke.RDS_SECONDS),
                                          smoke.APP_WFM[0]), smoke.FS,
                  bits=32)
        noise = smoke.served_config(cap, "manual", squelched=False)
        noise["ifnr"] = True
        runs = (
            ("phase 21, the served block", smoke.served_config(cap,
                                                               "manual"),
             (("Q", "set_squelch", f"{smoke.SQUELCH_DB}"),), 3),
            ("phase 23, the noise path (IF NR primed)", noise,
             (("W", "set_nb", "on"), ("N", "set_fmif", "on")), 8),
            ("phase 25, the RDS block", smoke.rds_config(rds, "manual"),
             (("V", "set_rds", "1"),), 2))
        for i, (label, config, cmds, warm) in enumerate(runs):
            app = smoke.new_app(os.path.join(tmp, f"app{i}"), config, dev)
            app._clock = lambda: 0.0
            app.start()
            for name, cmd, arg in cmds:
                app.modules[name].handle_debug_command(cmd, arg)
            try:
                profile_blocks(smoke, app, warm, a.blocks,
                               f"tree {tree}: {label}", card)
            finally:
                app.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
