"""K11's plan and index arithmetic, on the CPU (csrc/fused_mix.cu runs only
on the card).

``fused_frontend.fused_plan`` must cover every output of every channel
exactly once, keep each block inside one 1 024-output rotor group (the
span twiddle is then one value a block and channel), fit the H100's
227 KB of shared memory a block, and launch >= 132 blocks wherever the
call has that many blocks of its smallest size (128 outputs), at the
multimode8 10 MS/s bank's shapes, its 2.4 MS/s groups' stage 0 and every
shape the card tests use.  ``mix_chunks`` must split the channels as the
kernel's ``chunk_of`` does.

``tap_model`` runs the kernel's tap loops in numpy: the window staged by
input phase into D planes with a pad word every MIX_R, each thread's
MIX_R consecutive outputs, each plane's window sliding through a ring of
MIX_R registers (D = 2 and 4) or loaded at each tap (any other D).  Every
(output, tap) must read ext[m·D + k], in ascending k, and each window
load of a warp must hit 32 distinct banks."""

import numpy as np
import pytest

from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff

SMS, SMEM = 132, 232_448
R = ff.MIX_R


def bank_stage0(fs):
    """[(T, K, D, C)] of each group's K11 call on the multimode8 bank."""
    bank = rb.RadioBank(fs, rb.multimode8_vfos(), device="cpu")
    g = bank.in_multiple
    T = -(-int(fs * 0.1) // g) * g
    out = []
    for d, r in bank.radios.items():
        fused = r._build_vfo_shared().fused
        out.append((T, fused.K, fused.decim, len(bank.groups[d])))
    return out


CUDA_SHAPES = [(4 * 1000, 31, 4, 1), (4 * 260_017, 31, 4, 4),
               (4 * 777, 320, 4, 4), (2 * 4 * 9999, 34, 2, 64)]


def path_shapes():
    ten = bank_stage0(10e6)
    T, K, D, _ = ten[0]
    return ten + [(T, K, D, 12)] + bank_stage0(2.4e6) + CUDA_SHAPES


@pytest.mark.parametrize("C,ncm", [(C, n) for C in list(range(1, 21)) + [64]
                                   for n in (1, 2, 4, 8) if n <= C])
def test_mix_chunks_partition_the_channels(C, ncm):
    chunks = ff.mix_chunks(C, ncm)
    covered = [c for c0, n in chunks for c in range(c0, c0 + n)]
    assert covered == list(range(C))
    sizes = [n for _, n in chunks]
    assert all(n in (1, 2, 4, 8) and n <= ncm for n in sizes)
    assert sizes == sorted(sizes, reverse=True)
    # the kernel's launch counts chunks as C // ncm + popcount(C % ncm)
    assert len(chunks) == C // ncm + bin(C % ncm).count("1")


def test_fused_plan_covers_fits_and_fills():
    shapes = path_shapes()
    assert (1_040_000, 31, 4, 4) in shapes
    for T, K, D, C in shapes:
        p = ff.fused_plan(T, K, D, C)
        M, B = T // D, p["B"]
        assert p["threads"] * R == B and p["threads"] % 32 == 0
        assert 1024 % B == 0           # a block inside one rotor group
        assert p["smem"] == ff.mix_smem(B, K, D, p["ncm"]) <= SMEM
        count = np.zeros((C, M), np.int64)
        for bx in range(p["grid"][0]):
            lo, hi = bx * B, min(M, (bx + 1) * B)
            assert lo >> 10 == (bx * B + B - 1) >> 10
            for c0, n in p["chunks"]:
                count[c0:c0 + n, lo:hi] += 1
        assert (count == 1).all(), (T, K, D, C)
        assert p["blocks"] == p["grid"][0] * len(p["chunks"])
        most = -(-M // ff.MIX_BLOCKS[-1]) * len(p["chunks"])
        assert p["blocks"] >= min(SMS, most), (T, K, D, C, p)


def test_fused_plan_at_the_10msps_bank():
    """The bank's shape: C = 4 in one chunk of 4, 512-output blocks of 128
    threads, >= 2 blocks an SM; C = 12 in chunks of 8 and 4."""
    p = ff.fused_plan(1_040_000, 31, 4, 4)
    assert p["chunks"] == [(0, 4)] and p["B"] == 512
    assert p["blocks"] >= 2 * SMS
    assert ff.fused_plan(1_040_000, 31, 4, 12)["chunks"] == [(0, 8), (8, 4)]


def test_fused_plan_takes_every_tap_count_the_earlier_kernel_took():
    """The earlier kernel staged 255·D + K samples of each plane and 2·8·K
    taps: it took K up to (232 448 / 4 − 510·D) / 18.  A plan exists for
    all of those (halving the chunk, then the block)."""
    for D in (2, 4):
        k_max = (SMEM // 4 - 2 * 255 * D) // 18
        for K in (k_max // 4, k_max // 2, k_max):
            p = ff.fused_plan(1_040_000, K, D, 64)
            assert p["smem"] <= SMEM


def tap_model(B, K, D):
    """{(thread, r): [(k, ext offset from the block's first sample)]} of
    csrc/fused_mix.cu:tap_pass, and the banks of each warp-wide window
    load [(load site, [address of each thread])]."""
    L = B + -(-K // D) + R
    PS = L + L // R + 1
    j_of = {}
    for j in range(L):
        j_of[j + j // R] = j

    def ext_of(a):
        q, rem = divmod(a, PS)
        assert q < D and rem in j_of, a
        return j_of[rem] * D + q

    reads, loads = {}, {}
    for t in range(B // R):
        run = t * (R + 1)
        if D in (2, 4):
            S = -(-K // D)
            w = [[run + q * PS + x for x in range(R)] for q in range(D)]
            for q in range(D):
                for x in range(R):
                    loads.setdefault(("init", q, x), []).append(w[q][x])
            for s0 in range(0, S, R):
                p = run + s0 + s0 // R + R + 1
                for ds in range(R):
                    if s0 + ds >= S:
                        break
                    for q in range(D):
                        k = (s0 + ds) * D + q
                        if k < K:
                            for r in range(R):
                                reads.setdefault((t, r), []).append(
                                    (k, ext_of(w[q][(ds + r) % R])))
                        w[q][ds] = p + q * PS + ds
                        loads.setdefault((s0, ds, q), []).append(w[q][ds])
        else:
            for k in range(K):
                s = k // D
                base = run + (k - s * D) * PS
                for r in range(R):
                    a = base + s + r + (s + r) // R
                    reads.setdefault((t, r), []).append((k, ext_of(a)))
                    loads.setdefault((k, r), []).append(a)
    return reads, loads


@pytest.mark.parametrize("D", [2, 3, 4])
@pytest.mark.parametrize("K", [31, 34, 320])
def test_tap_model_reads_every_tap_in_order(D, K):
    B = 128
    reads, loads = tap_model(B, K, D)
    assert len(reads) == B
    for (t, r), seq in reads.items():
        m = t * R + r
        assert [k for k, _ in seq] == list(range(K))
        assert [e for _, e in seq] == [m * D + k for k in range(K)]
    # a warp's window loads: 32 threads, 32 distinct banks
    for site, addrs in loads.items():
        for w0 in range(0, len(addrs), 32):
            banks = {a % 32 for a in addrs[w0:w0 + 32]}
            assert len(banks) == len(addrs[w0:w0 + 32]), site


def test_staging_layout_is_one_to_one():
    """Each window sample idx < L·D lands at plane idx % D, word j + j/R
    (j = idx // D), inside the plane stride the layout sizes."""
    for B, K, D in ((512, 31, 4), (128, 34, 2), (256, 320, 4), (128, 17, 3)):
        L = B + -(-K // D) + R
        PS = L + L // R + 1
        idx = np.arange(L * D)
        j = idx // D
        addr = (idx % D) * PS + j + j // R
        assert len(set(addr.tolist())) == L * D
        assert ((addr % PS) < PS - 1).all() and addr.max() < D * PS
