"""The plan of K13's M&M and FD forms (csrc/loops.cu: mm_kernel), on the
CPU: ``clock_recovery.run_bound``, the runs' bound that the wrappers pass
to the kernel, and ``clock_recovery.mm_schedule`` (a ring of chunks staged
by two warps, the chain in runs of up to 32 unchecked steps), the model
the kernel follows.  Every sample is staged once, every window of a run
lies in chunks staged and not yet passed, the chain never waits on a chunk
the staging warps cannot have written, and every output is written once,
at the lengths and samples a symbol the card tests take.  The wrappers
refuse a bank whose rows the runs cannot index by a mask."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.ops import clock_recovery as cr


def _clock(sps):
    return cr.FDClockRecovery(sps) if sps == 10.0 else \
        cr.MMClockRecovery(sps, 1e-6, 0.01, 0.01)


@pytest.mark.parametrize("P", [3, 100, 129])
@pytest.mark.parametrize("form", ["mm_real", "mm_cplx", "fd"])
def test_kernels_refuse_a_bank_not_a_power_of_two(form, P):
    """The kernel takes the bank's row from the phase by a mask, so its
    wrappers refuse another row count before they launch (here on a CPU
    tensor, which the dispatch would give to the plain version)."""
    if form == "fd":
        blk, fn = cr.FDClockRecovery(3.0, interp_phase_count=P), \
            cr.fd_rows_kernel
    else:
        blk, fn = cr.MMClockRecovery(3.0, interp_phase_count=P,
                                     complex_data=form == "mm_cplx"), \
            cr.mm_rows_kernel
    x = torch.zeros(1, 64, dtype=torch.complex64 if blk.complex_data
                    else torch.float32)
    with pytest.raises(ValueError, match="power of two rows"):
        fn(blk, x, blk.init_state((1,)))


@pytest.mark.parametrize("sps", [1.68, 2.08, 3.0, 4.21, 10.0])
def test_run_bound_covers_every_advance(sps):
    """The runs' bound is at least the largest floor of a step's phase
    once it is in [0, 1) (float32 sums round monotonically), and every
    caller's loop only moves forward."""
    mm = _clock(sps)
    alpha, _, fmin, fmax = (np.float32(v) for v in cr._coefs(mm))
    dmax = cr.run_bound(mm)
    assert dmax >= 1
    rng = np.random.default_rng(int(sps * 100))
    ph = rng.uniform(0, 1, 100_000).astype(np.float32)
    ph[:2] = (0.0, np.nextafter(np.float32(1), np.float32(0)))
    fr = rng.uniform(fmin, fmax, ph.size).astype(np.float32)
    fr[:2] = fmax
    err = rng.uniform(-1, 1, ph.size).astype(np.float32)
    err[:2] = 1.0
    raw = (ph + fr) + alpha * err
    assert np.floor(raw).max() <= dmax
    assert np.floor(raw).min() >= 0


def _advances(kind, mm, n):
    """A step's advance: always the fewest or the most, or random between
    (a loop's floors lie between them)."""
    alpha, _, fmin, _ = (np.float32(v) for v in cr._coefs(mm))
    lo, hi = int(np.floor(fmin - abs(alpha))), cr.run_bound(mm)
    if kind == "least":
        return lambda i: lo
    if kind == "most":
        return lambda i: hi
    d = np.random.default_rng(n).integers(lo, hi + 1, n + 1)
    return lambda i: int(d[i])


@pytest.mark.parametrize("kind", ["least", "most", "random"])
@pytest.mark.parametrize("sps", [1.68, 2.08, 3.0, 4.21, 10.0])
@pytest.mark.parametrize("T", [1, 4095, 4096, 4097, 72_000])
def test_mm_schedule_stages_reads_and_writes_once(T, sps, kind):
    mm = _clock(sps)
    n_out = mm.max_out(T)
    n_ext = mm.K - 1 + T
    for offset in (-9, -2, 0, 5, T + 3):
        s = cr.mm_schedule(T, offset, n_out, cr.run_bound(mm),
                           _advances(kind, mm, n_out))
        e0, CH = s["e0"], cr.RING_CHUNK
        # every sample of [tail | x] from e0 staged once, in order
        cov = []
        for c, (start, n, slot) in enumerate(s["chunks"]):
            assert (start, slot) == (e0 + c * CH, c % cr.RING_CHUNKS)
            cov += range(start, start + n)
        assert cov == list(range(e0, n_ext))
        # chunks waited for and passed once each, in order; every window
        # read from the ring in chunks waited for and not yet passed
        avail = released = 0
        for ev in s["events"]:
            if ev[0] == "acquire":
                assert ev[1] == avail
                avail += 1
            elif ev[0] == "release":
                assert ev[1] == released < avail
                released += 1
            elif ev[2] == "ring":
                assert e0 + released * CH <= ev[1]
                assert ev[1] + mm.K <= e0 + avail * CH
        assert avail == released == len(s["chunks"])
        # every symbol written once; the valid ones a prefix
        written = []
        for first, count, how in s["symbols"]:
            written += range(first, first + count)
            if how == "fill":
                assert first == s["valid"] + 1
        assert written == list(range(n_out))
        if offset >= T:
            assert s["valid"] == 0
        elif T > 100:
            assert s["valid"] > T // (2 * sps)
            # one at a time: the first step, those whose window is clamped
            # at the block's start (a step advances >= 1), the first past it
            steps = sum(c for _, c, h in s["symbols"] if h == "step")
            assert steps <= 2 + max(0, -offset)
