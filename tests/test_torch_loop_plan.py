"""The plans of the loop kernels, on the CPU.

K12 (csrc/agc.cu): ``agc.ring_schedule``, the order of the chain and
output warps on their named barriers and shared-memory rings (K12c's |x|
ring among them), run under the barriers' rules in many interleavings:
no deadlock, no barrier completed by one warp twice, every read of a
ring slot the batch it expects, no barrier left open; the constants the
model takes are the kernel's.

K16's warp form (csrc/viterbi.cu: viterbi_warp_kernel):
``fec.viterbi_warp_plan``, the lane and register that own each state and
those its two predecessors' metrics are shuffled from, against the
trellis (``fec.predecessor_outputs``) at S = 4, 16, 32 and 64;
``fec.viterbi_trace_plan``, the traceback's look-ahead, reading each
decision word once, of a step the trellis wrote, before its use; and a
numpy model of the warp form through both plans bit for bit against the
plain version.

K13's M&M and FD forms (csrc/loops.cu: mm_kernel), on the
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

import os
import re

from sdrplusplusbrown_tpu_torch.ops import agc
from sdrplusplusbrown_tpu_torch.ops import clock_recovery as cr
from sdrplusplusbrown_tpu_torch.ops import fec

CSRC = os.path.join(os.path.dirname(fec.__file__), os.pardir, "csrc")


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


# ---- K16's warp form -------------------------------------------------------

#: a code a state count of the warp form: D-STAR's K = 3, M17's K = 5, a
#: K = 6 code (S = 32, no caller) and RyFi's K = 7
WARP_CODES = {4: (0b111, 0b101, 3), 16: (0b11001, 0b10111, 5),
              32: (0o75, 0o53, 6), 64: (0o161, 0o127, 7)}


@pytest.mark.parametrize("S", sorted(WARP_CODES))
def test_viterbi_warp_plan_matches_the_trellis(S):
    """Every state is one lane's (the lanes past S copy a live lane),
    each shuffle reads one register name in every lane, from the lane
    that owns the predecessor, and the lane reads the predecessor's
    coded pair, as the trellis has them."""
    g1, g2, k = WARP_CODES[S]
    p = fec.viterbi_warp_plan(g1, g2, k)
    state, src, code = p["state"], p["src"], p["code"]
    assert p["S"] == S and p["regs"] == (2 if S == 64 else 1)
    owners = {}
    for lane in range(min(S, 32)):
        for q in range(p["regs"]):
            owners.setdefault(int(state[lane, q]), []).append((lane, q))
    assert sorted(owners) == list(range(S))
    assert all(len(v) == 1 for v in owners.values())
    for lane in range(S, 32):       # copies: the same state and sources
        assert (state[lane] == state[lane % S]).all()
        assert (src[lane] == src[lane % S]).all()
    pred = fec.predecessor_outputs(g1, g2, k)
    for q in range(p["regs"]):
        for w in (0, 1):
            assert len(set(src[:, q, w, 1])) == 1      # one register a shuffle
            for lane in range(32):
                n = int(state[lane, q])
                sl, sr = src[lane, q, w]
                assert 0 <= sl < 32
                assert state[sl, sr] == (n >> 1) + w * (S // 2)
                e0, e1 = pred[n, w]
                assert code[lane, q, w] == 2 * int(e0) + int(e1)


def test_viterbi_warp_plan_refuses_the_block_form():
    with pytest.raises(ValueError, match="at most 64"):
        fec.viterbi_warp_plan(0o561, 0o753, 9)


@pytest.mark.parametrize("N", [3, 31, 32, 33, 54, 148, 244, 330, 8168,
                               30_000])
def test_viterbi_trace_plan_reads_each_word_once_ahead(N):
    """The traceback's loads: each step's decision word once, only steps
    the trellis wrote (0 <= t < N), each into the register its use reads
    and, past the top group's 32 steps, 32 uses ahead of it; the uses
    walk every step once, from N - 1 down."""
    events = fec.viterbi_trace_plan(N)
    loads = [t for kind, t, _ in events if kind == "load"]
    uses = [t for kind, t, _ in events if kind == "use"]
    assert sorted(loads) == list(range(N))
    assert uses == list(range(N - 1, -1, -1))
    reg, at, seen = {}, {}, 0
    for kind, t, j in events:
        if kind == "load":
            assert j not in reg          # the register's word was used
            reg[j], at[j] = t, seen
        else:
            assert reg.pop(j) == t
            if t < N - 32:
                assert seen - at[j] >= 31
            seen += 1
    assert not reg


def _warp_model(soft, g1, g2, k):
    """The warp form in numpy float32 (each operation rounded): the
    metrics in [32, regs] lane registers, a step's predecessors through
    the plan's shuffles, its branch metrics from the table row by the
    plan's codes, the decisions as the lanes' ballots; the argmin of the
    final metrics, then the traceback through ``viterbi_trace_plan``."""
    f = np.float32
    p = fec.viterbi_warp_plan(g1, g2, k)
    S, regs, state, src, code = (p[x] for x in ("S", "regs", "state",
                                                "src", "code"))
    N = soft.size // 2
    o = soft.reshape(N, 2).astype(f)
    m = np.where(state == 0, f(0), f(fec.BIG)).astype(f)
    words = np.zeros(N, np.uint64)
    for t in range(N):
        table = np.array([(o[t, 0] - f(e0)) * (o[t, 0] - f(e0))
                          + (o[t, 1] - f(e1)) * (o[t, 1] - f(e1))
                          for e0 in (0, 1) for e1 in (0, 1)], f)
        pm = m[src[..., 0], src[..., 1]]                  # [32, regs, 2]
        c = pm + table[code]
        new = np.minimum(np.minimum(c[..., 0], c[..., 1]), f(fec.BIG))
        hi = c[..., 1] <= new + f(fec.TIE)
        for q in range(regs):
            word = sum(int(hi[lane, q]) << lane for lane in range(32))
            words[t] |= np.uint64(word << (32 * q))
        m = new
    lanes = min(S, 32)
    flat = np.zeros(S, f)
    for q in range(regs):
        flat[state[:lanes, q]] = m[:lanes, q]
    s = int(np.argmin(flat))
    reg, bits = {}, np.zeros(N, np.uint8)
    for kind, t, j in fec.viterbi_trace_plan(N):
        if kind == "load":
            reg[j] = int(words[t])
        else:
            bits[t] = s & 1
            s = (((reg.pop(j) >> s) << (k - 2)) | (s >> 1)) & (S - 1)
    return bits[:N - (k - 1)], flat


@pytest.mark.parametrize("N", [30, 33, 100, 244])
@pytest.mark.parametrize("S", sorted(WARP_CODES))
def test_viterbi_warp_model_matches_plain(S, N):
    """The numpy model of the warp form, through both plans, gives the
    plain version's bits and final metrics bit for bit (hard bits with
    ties, and soft noise with erasures)."""
    g1, g2, k = WARP_CODES[S]
    rng = np.random.default_rng(S * N)
    for hard in (True, False):
        c = fec.conv_encode(rng.integers(0, 2, N - (k - 1)), g1, g2,
                            k).astype(np.float32)
        if hard:
            idx = rng.choice(c.size, c.size // 12, replace=False)
            c[idx] = 1.0 - c[idx]
        else:
            c = np.clip(c + 0.35 * rng.standard_normal(c.size), 0.0, 1.0)
        c[rng.choice(c.size, c.size // 16, replace=False)] = 0.5
        c = c.astype(np.float32)
        bits, final = _warp_model(c, g1, g2, k)
        wb, wf = fec.viterbi_rows_ref(torch.from_numpy(c)[None], g1, g2, k)
        np.testing.assert_array_equal(bits, wb[0].numpy())
        np.testing.assert_array_equal(final, wf[0].numpy())


# ---- K12's rings -------------------------------------------------------------

def _run_warps(sched: dict, pick) -> None:
    """Run the two warps' events under the named barriers' rules (a warp
    is 32 threads; a barrier of 64 completes when both warps have
    arrived, ``sync`` waiting for that, ``arrive`` not) with ``pick``
    choosing which runnable warp steps next; fail on a deadlock, on a
    warp arriving twice at one barrier before it completes (the hardware
    would count both), on a read that finds another batch than it
    expects, and on a barrier left open."""
    pos = {w: 0 for w in sched}
    arrived = {}                  # barrier id -> warps arrived, this round
    blocked = {}                  # warp -> the barrier round it waits on
    rounds = {}                   # barrier id -> rounds completed
    slots = {}
    while True:
        runnable = [w for w in sched if pos[w] < len(sched[w])
                    and (w not in blocked
                         or rounds.get(blocked[w][0], 0) > blocked[w][1])]
        if not runnable:
            break
        w = pick(runnable)
        blocked.pop(w, None)
        ev = sched[w][pos[w]]
        pos[w] += 1
        if ev[0] in ("arrive", "sync"):
            bid = ev[1]
            got = arrived.setdefault(bid, set())
            assert w not in got, f"{w} arrives twice at barrier {bid}"
            got.add(w)
            if ev[0] == "sync":
                blocked[w] = (bid, rounds.get(bid, 0))
            if len(got) == 2:
                rounds[bid] = rounds.get(bid, 0) + 1
                got.clear()
        elif ev[0] == "write":
            slots[ev[1], ev[2]] = ev[3]
        else:
            assert slots.get((ev[1], ev[2])) == ev[3], (w, ev, slots.get(
                (ev[1], ev[2])))
    stuck = {w: sched[w][pos[w]] for w in sched if pos[w] < len(sched[w])}
    assert not stuck, f"deadlock: {stuck}"
    assert not any(arrived.values()), f"barriers left open: {arrived}"


@pytest.mark.parametrize("frozen", [False, True], ids=["live", "frozen"])
@pytest.mark.parametrize("cplx", [True, False], ids=["K12c", "K12"])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 1000, 15_000, 72_000])
def test_agc_rings_never_deadlock_and_read_their_batch(T, cplx, frozen):
    sched = agc.ring_schedule(T, cplx, frozen)
    rng = np.random.default_rng(T)
    picks = [lambda r: r[0], lambda r: r[-1]]          # each warp first
    # runs of one warp at random lengths: one warp far ahead, then the
    # other
    for seed in range(4 if T > 10_000 else 12):
        g = np.random.default_rng(seed)

        def runs(r, g=g, state={"w": None, "left": 0}):
            if state["left"] <= 0 or state["w"] not in r:
                state["w"] = r[int(g.integers(len(r)))]
                state["left"] = int(g.integers(1, 200))
            state["left"] -= 1
            return state["w"]
        picks.append(runs)
    picks.append(lambda r: r[int(rng.integers(len(r)))])
    for pick in picks:
        _run_warps(sched, pick)


def test_agc_ring_constants_are_the_kernels():
    """The model's ring sizes and barrier ids are csrc/agc.cu's."""
    with open(os.path.join(CSRC, "agc.cu")) as fh:
        src = fh.read()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (SLOTS|MAGS|AHEAD) = (\d+);", src)}
    assert got == {"SLOTS": agc.SLOTS, "MAGS": agc.MAGS,
                   "AHEAD": agc.AHEAD}
    assert "constexpr int START = 1 + 2 * SLOTS;" in src
    assert agc.START == 1 + 2 * agc.SLOTS
    with open(os.path.join(CSRC, "viterbi.cu")) as fh:
        assert f"constexpr int WARP_STATES = {fec.WARP_STATES};" in fh.read()
