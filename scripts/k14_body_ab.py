#!/usr/bin/env python3
"""K14's device µs a call on handed-over rings, one tree at a time, for a
comparison of two K14 bodies on one NVIDIA GPU:

    python3 scripts/k14_body_ab.py [--tree DIR] [--reps N]

At the served IF NR's shapes (``LogMMSE(2.4e6, wideband=True)``: nFFT
96 000 bins, rings of 200 frames; five frames a 120 000-sample block) and
at priming's 12 frames, K14 runs as the pump runs it: each call on the
state the call before returned, its rings written in place
(ops/logmmse.py:hand_over), no copy.  ``chip_smoke.call_profile`` gives
the device µs a call.  The first call's rings, sums and counters are held
bit for bit to the plain version's, its gains to 100 dB.  The rings start
full (the count past 200), as a served stream leaves them.  ``--tree DIR``
imports the port from another checkout (unpacked with ``git archive``
into a directory ``.gitignore`` lists); run two trees A / B / B / A in
one call.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inputs(core, frames: int, seed: int, dev):
    """A LogMMSE state with full rings of |spectrum|-like values and
    ``frames`` frames of magnitudes, made on the card from ``seed``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    N, H = core.nFFT, core.H

    def mag(*s):
        return torch.rand(s, generator=g, device=dev) * 2.0 + 1e-3
    st = {k: v.to(dev) for k, v in core.init_state(()).items()}
    hist, dev_hist = mag(H, N), mag(H, N) ** 2
    st.update(hist=hist, dev_hist=dev_hist, sums=hist.sum(0),
              devs=dev_hist.sum(0),
              count=torch.tensor(H + 37, dtype=torch.int32, device=dev),
              pos=torch.tensor(37, dtype=torch.int32, device=dev),
              noise_mu2=mag(N) ** 2, Xk_prev=mag(N) ** 2,
              has_prev=torch.tensor(True, device=dev))
    return st, mag(frames, N) * 2.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=50)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k14_body_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    dev = torch.device("cuda", 0)
    tree = os.path.relpath(os.path.abspath(a.tree), ROOT)
    core = plm.LogMMSE(2.4e6, wideband=True)
    for frames in (5, 12):
        st, sig = inputs(core, frames, frames, dev)
        want, want_hw = plm.logmmse_frames_ref(core, smoke.state_copy(st),
                                               sig, None)
        got, got_hw = plm.logmmse_frames_kernel(core, smoke.state_copy(st),
                                                sig, None)
        torch.cuda.synchronize()
        for k in ("hist", "dev_hist", "sums", "devs", "count", "pos"):
            if not torch.equal(got[k], want[k]):
                print(f"tree {tree}: K14 {k} differs from the plain "
                      f"version", flush=True)
                return 1
        db = smoke.snr_db(want_hw, got_hw)
        if db < 100.0:
            print(f"tree {tree}: K14's gains {db:.1f} dB from the plain "
                  f"version", flush=True)
            return 1
        us, n = smoke.call_profile(
            smoke.k14_chain(plm.logmmse_frames_kernel, (core, st, sig,
                                                        None)), a.reps)
        print(f"tree {tree}: K14 at nFFT {core.nFFT} x {frames} frames, "
              f"rings of {core.H}: {us:.2f} us device a call on handed-over "
              f"rings ({n} launches a call; gains {db:.1f} dB from the "
              f"plain version, rings and counters bit-identical) [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
