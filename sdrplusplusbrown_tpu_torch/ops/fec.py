"""Forward error correction: convolutional codes (Viterbi) and
Reed-Solomon (counterpart of sdrplusplusbrown_tpu/ops/fec.py; reference
core/libcorrect, vendored: convolutional r=1/2 K=7..9 codes and
RS(255,223), used by the decoder modules — M17, KG-SSTV, RyFi, and later
falcon9, dstar, pager).

The Viterbi decoder is kernel K16 (csrc/viterbi.cu: up to 64 states one
warp a frame, the metrics in registers exchanged by shuffles, the plan
``viterbi_warp_plan``, the traceback's loads ``viterbi_trace_plan``; more
states one block a frame, a thread a state) on a CUDA tensor and
``viterbi_rows_ref``,
the same add-compare-select vectorised over frames and states, with the
JAX package's host traceback, on a CPU tensor.  Both keep the JAX
package's arithmetic and tie rules bit for bit:

  * the branch metric (o0 − e0)² + (o1 − e1)², each operation rounded;
  * new = min(1e9, c_lo, c_hi), the JAX scatter-min from 1e9 (an
    unreachable state stays at 1e9: 1e9 + bm rounds back to it);
  * the high predecessor, (n >> 1) + S/2, where its candidate is within
    1e-6 of the minimum (float32): the JAX "larger origin index among the
    branches with cand <= new + 1e-6";
  * the traceback from the first smallest final metric (``np.argmin``).

Every caller here flushes the encoder to state 0 (``conv_encode`` appends
K − 1 zeros, RyFi pads zeros after that), so the argmin start is state 0
on a frame with a correctable error count.

Convolutional encoding and Reed–Solomon are host numpy over GF(256),
copied from the JAX package (tiny blocks at decode rates, as the
reference's CPU path).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..kernels import _build
from ..runtime.block import entry_device

# CCSDS / "NASA standard" K=7 rate-1/2 polynomials (libcorrect's default)
G1, G2 = 0o171, 0o133

#: bytes of shared memory K16 keeps a frame's decisions in (csrc/viterbi.cu
#: DEC_SMEM_MAX); a longer frame keeps them in global scratch
DEC_SMEM_MAX = 160 * 1024
BIG = 1e9
TIE = 1e-6
#: the most states K16's warp form takes (csrc/viterbi.cu WARP_STATES):
#: every code of the port's callers (K = 3, 5 and 7); more states run the
#: block form
WARP_STATES = 64
#: steps of a traceback group: the warp form loads each group's decision
#: words during the group before
TRACE_GROUP = 32


def conv_encode(bits: np.ndarray, g1: int = G1, g2: int = G2,
                k: int = 7) -> np.ndarray:
    """Rate-1/2 convolutional encoder (zero-flushed)."""
    bits = np.asarray(bits, np.uint8)
    state = 0
    out = np.empty(2 * (len(bits) + k - 1), np.uint8)
    idx = 0
    for b in list(bits) + [0] * (k - 1):
        state = ((state << 1) | int(b)) & ((1 << k) - 1)
        out[idx] = bin(state & g1).count("1") & 1
        out[idx + 1] = bin(state & g2).count("1") & 1
        idx += 2
    return out


def _branch_tables(g1: int, g2: int, k: int):
    """For each (state, input bit): output pair and next state."""
    n_states = 1 << (k - 1)
    nxt = np.zeros((n_states, 2), np.int32)
    outs = np.zeros((n_states, 2, 2), np.float32)
    for s in range(n_states):
        for b in (0, 1):
            full = ((s << 1) | b) & ((1 << k) - 1)
            nxt[s, b] = full & (n_states - 1)
            outs[s, b, 0] = bin(full & g1).count("1") & 1
            outs[s, b, 1] = bin(full & g2).count("1") & 1
    return nxt, outs


def predecessor_outputs(g1: int, g2: int, k: int) -> np.ndarray:
    """[S, 2, 2] float32: for next state n, the coded pair its low (n >> 1)
    and its high ((n >> 1) + S/2) predecessor emit on the way to it (the
    full registers n and n + S); ``_branch_tables``'s outputs regrouped by
    next state."""
    nxt, outs = _branch_tables(g1, g2, k)
    S = 1 << (k - 1)
    out = np.zeros((S, 2, 2), np.float32)
    for n in range(S):
        for which, s in enumerate((n >> 1, (n >> 1) + S // 2)):
            assert nxt[s, n & 1] == n
            out[n, which] = outs[s, n & 1]
    return out


def _pair(reg: int, g1: int, g2: int) -> int:
    """The coded pair a full K-bit register emits, as 2 e0 + e1."""
    return 2 * (bin(reg & g1).count("1") & 1) + (bin(reg & g2).count("1")
                                                 & 1)


def viterbi_warp_plan(g1: int, g2: int, k: int) -> dict:
    """K16's warp form (csrc/viterbi.cu:viterbi_warp_kernel), one warp a
    frame, for S = 2^(k−1) ≤ WARP_STATES states; the kernel computes the
    same from its lane index:

      * ``regs``: states a lane, 2 where S = 64, else 1;
      * ``state`` [32, regs]: the state lane L keeps in register q: L +
        32 q, or L mod S where S ≤ 32 (the lanes from S on copy lane L
        mod S: their shuffles read live lanes, their bits are never read);
      * ``src`` [32, regs, 2, 2]: for that state's low (0) and high (1)
        predecessor, (n >> 1) and (n >> 1) + S/2, the (lane, register)
        the step shuffles its metric from: one shuffle a (q, w), so each
        reads one register in every lane;
      * ``code`` [32, regs, 2]: the pair each predecessor emits on the
        way, 2 e0 + e1 of the full registers n and n + S: the column of
        the step's branch-metric table the lane reads."""
    S = 1 << (k - 1)
    if S > WARP_STATES:
        raise ValueError(f"K16's warp form: {S} states, at most "
                         f"{WARP_STATES}")
    regs = 2 if S == WARP_STATES else 1
    state = np.zeros((32, regs), np.int64)
    src = np.zeros((32, regs, 2, 2), np.int64)
    code = np.zeros((32, regs, 2), np.int64)
    for lane in range(32):
        for q in range(regs):
            n = lane + 32 * q if regs == 2 else lane & (S - 1)
            state[lane, q] = n
            lo = n >> 1
            for w in (0, 1):
                src[lane, q, w] = (lo & 31, w) if regs == 2 else \
                    (lo + w * S // 2, 0)
                code[lane, q, w] = _pair(n + w * S, g1, g2)
    return {"S": S, "regs": regs, "state": state, "src": src,
            "code": code}


def viterbi_trace_plan(N: int) -> list:
    """The warp form's traceback over N steps, as csrc/viterbi.cu runs
    it: groups of TRACE_GROUP steps [g, g + 32) from the top one (g = N
    − 32) down by 32, the last one (g ≤ 0) with its steps below 0
    skipped; a group's words in registers 0..31 by position (step g + 31
    − j in register j).  The events in program order: ("load", t, j)
    puts step t's decision word into register j; ("use", t, j) is step
    t's traceback step reading register j.  The top group's words are
    loaded before the walk; every later group's word for position j
    during the group before, right after that group's use of register
    j."""
    G = TRACE_GROUP
    events = [("load", N - 1 - j, j) for j in range(G) if N - 1 - j >= 0]
    g = N - G
    while True:
        last = g <= 0
        for j in range(G):
            t = g + G - 1 - j
            if not last or t >= 0:
                events.append(("use", t, j))
            if not last and g - 1 - j >= 0:
                events.append(("load", g - 1 - j, j))
        if last:
            return events
        g -= G


def _check(soft, k):
    if soft.dtype != torch.float32 or soft.dim() != 2 or soft.shape[1] % 2:
        raise ValueError(f"Viterbi rows: {tuple(soft.shape)} {soft.dtype}, "
                         f"expected float32 [frames, 2N]")
    if not 2 <= k <= 11 or soft.shape[1] // 2 < k:
        raise ValueError(f"Viterbi: K = {k} on {soft.shape[1] // 2} steps")


def viterbi_rows_ref(soft, g1: int = G1, g2: int = G2, k: int = 7):
    """Plain PyTorch K16: soft float32 [R, 2N] → (bits uint8 [R, N − (k −
    1)], final metrics float32 [R, S]).  The add-compare-select a step is
    vectorised over frames and states; the traceback is the JAX package's
    host loop."""
    _check(soft, k)
    R, N = soft.shape[0], soft.shape[1] // 2
    S = 1 << (k - 1)
    dev = soft.device
    e = torch.from_numpy(predecessor_outputs(g1, g2, k)).to(dev)
    obs = soft.reshape(R, N, 1, 1, 2)
    d = obs - e                                       # [R, N, S, 2, 2]
    bm = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]   # [R, N, S, 2]
    lo = torch.arange(S, device=dev) >> 1
    hi = lo + S // 2
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    tie = torch.tensor(TIE, dtype=torch.float32, device=dev)
    met = torch.full((R, S), BIG, dtype=torch.float32, device=dev)
    met[:, 0] = 0.0
    dec = torch.empty(R, N, S, dtype=torch.bool, device=dev)
    for t in range(N):
        c_lo = met[:, lo] + bm[:, t, :, 0]
        c_hi = met[:, hi] + bm[:, t, :, 1]
        new = torch.minimum(torch.minimum(c_lo, c_hi), big)
        dec[:, t] = c_hi <= new + tie
        met = new
    d_np = dec.cpu().numpy()
    bits = np.zeros((R, N), np.uint8)
    for r, s in enumerate(np.argmin(met.cpu().numpy(), axis=1)):
        s = int(s)
        for t in range(N - 1, -1, -1):
            bits[r, t] = s & 1
            s = (s >> 1) + (S // 2 if d_np[r, t, s] else 0)
    return torch.from_numpy(bits[:, :N - (k - 1)]).to(dev), met


def viterbi_scratch(N: int, k: int, R: int, device):
    """K16's global scratch for a frame of N steps, or None where its
    decisions fit in shared memory."""
    W = ((1 << (k - 1)) + 31) // 32
    if N * W * 4 <= DEC_SMEM_MAX:
        return None
    return torch.empty(R, N, W, dtype=torch.int32, device=device)


@_build.counted
def viterbi_rows_kernel(soft, g1: int = G1, g2: int = G2, k: int = 7,
                        clk=None):
    """K16 on the card (csrc/viterbi.cu); same contract as
    ``viterbi_rows_ref``.  ``clk``: see ``_build.chain_clock``; two
    slots, the trellis's and the argmin and traceback's."""
    dev = soft.device
    _check(soft, k)
    R, N = soft.shape[0], soft.shape[1] // 2
    bits = torch.empty(R, N - (k - 1), dtype=torch.uint8, device=dev)
    final = torch.empty(R, 1 << (k - 1), dtype=torch.float32, device=dev)
    scratch = viterbi_scratch(N, k, R, dev)
    _build.launch(
        "sdr_viterbi_rows", dev,
        _build.check(soft, "Viterbi soft", torch.float32, device=dev), R, N,
        int(g1), int(g2), int(k),
        None if scratch is None else scratch.data_ptr(), bits.data_ptr(),
        final.data_ptr(), _build.chain_clock(clk, R, dev, slots=2))
    return bits, final


viterbi_rows_kernel.clock_slots = 2


def viterbi_rows(soft, g1: int = G1, g2: int = G2, k: int = 7):
    """K16 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = viterbi_rows_kernel if soft.is_cuda else viterbi_rows_ref
    return fn(soft, g1, g2, k)


def viterbi_decode(soft, g1: int = G1, g2: int = G2, k: int = 7,
                   device=None) -> np.ndarray:
    """Soft-decision Viterbi decode of a rate-1/2 stream.

    ``soft``: [2N] values in [0, 1] (0 → bit 0, 1 → bit 1; hard bits
    work too), a tensor (decoded on its device) or an array (on
    ``device``: CUDA unless the caller asks for the CPU).  Returns the
    N − (k − 1) decoded data bits (zero flush assumed) as host uint8."""
    return viterbi_decode_frames([soft], g1, g2, k, device)[0]


def viterbi_decode_frames(frames, g1: int = G1, g2: int = G2, k: int = 7,
                          device=None) -> List[np.ndarray]:
    """``viterbi_decode`` of frames of one length in one K16 launch."""
    if not frames:
        return []
    if device is None:
        device = frames[0].device if isinstance(frames[0], torch.Tensor) \
            else "cuda"
    dev = entry_device(device)
    soft = torch.stack([torch.as_tensor(np.asarray(f, np.float32)
                                        if not isinstance(f, torch.Tensor)
                                        else f).reshape(-1).float()
                        .to(dev) for f in frames]).contiguous()
    bits, _ = viterbi_rows(soft, g1, g2, k)
    return list(bits.cpu().numpy())


# ----------------------------------------------------------------------
# Reed-Solomon over GF(256), primitive poly 0x11d (RS(255,223) default —
# the CCSDS/libcorrect configuration)

_PRIM = 0x11D
_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
_EXP[255:510] = _EXP[:255]


def _gmul(a, b):
    if a == 0 or b == 0:
        return 0
    return int(_EXP[(_LOG[a] + _LOG[b]) % 255])


def _poly_mul(p, q):
    r = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            r[i + j] ^= _gmul(a, b)
    return r


def rs_generator(nsym: int) -> List[int]:
    g = [1]
    for i in range(nsym):
        g = _poly_mul(g, [1, int(_EXP[i])])
    return g


def rs_encode(data: bytes, nsym: int = 32) -> bytes:
    """Systematic RS encode: returns data + nsym parity bytes."""
    gen = rs_generator(nsym)
    rem = [0] * nsym
    for b in data:
        factor = b ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            for i in range(nsym):
                rem[i] ^= _gmul(gen[i + 1], factor)
    return bytes(data) + bytes(rem)


def _ginv(a):
    return int(_EXP[(255 - _LOG[a]) % 255])


def _poly_scale(p, x):
    return [_gmul(c, x) for c in p]


def _poly_add(p, q):
    r = [0] * max(len(p), len(q))
    r[len(r) - len(p):] = [c for c in p]
    for i, c in enumerate(q):
        r[i + len(r) - len(q)] ^= c
    return r


def _poly_eval(p, x):
    """Evaluate polynomial (coefficients highest-order first)."""
    y = 0
    for c in p:
        y = _gmul(y, x) ^ int(c)
    return y


def _syndromes(msg, nsym: int):
    return [int(_poly_eval(list(msg), int(_EXP[i]))) for i in range(nsym)]


def rs_decode(block: bytes, nsym: int = 32) -> Optional[bytes]:
    """Berlekamp-Massey + Chien search + Forney. Returns corrected data
    (parity stripped) or None if uncorrectable.  Standard erasureless
    decoder (the classic public formulation, e.g. "Reed-Solomon codes
    for coders")."""
    msg = list(block)
    n = len(msg)
    synd = _syndromes(msg, nsym)
    if max(synd) == 0:
        return bytes(block[:-nsym])

    # Berlekamp-Massey (coefficients highest-order first)
    err_loc = [1]
    old_loc = [1]
    for i in range(nsym):
        old_loc.append(0)
        delta = synd[i]
        for j in range(1, len(err_loc)):
            delta ^= _gmul(err_loc[-(j + 1)], synd[i - j])
        if delta != 0:
            if len(old_loc) > len(err_loc):
                new_loc = _poly_scale(old_loc, delta)
                old_loc = _poly_scale(err_loc, _ginv(delta))
                err_loc = new_loc
            err_loc = _poly_add(err_loc, _poly_scale(old_loc, delta))
    while err_loc and err_loc[0] == 0:
        err_loc.pop(0)
    n_err = len(err_loc) - 1
    if n_err * 2 > nsym:
        return None

    # Chien search: err_loc(alpha^i) == 0  =>  coef power cp = 255-i,
    # byte position p = n-1-cp
    err_pos = []
    coef_pos = []
    for i in range(255):
        if _poly_eval(err_loc, _pow(2, i)) == 0:
            cp = (255 - i) % 255
            p = n - 1 - cp
            if 0 <= p < n:
                err_pos.append(p)
                coef_pos.append(cp)
    if len(err_pos) != n_err:
        return None

    # Forney (roots start at alpha^0):
    #   omega(x) = S(x)*Lambda(x) mod x^n_err          (low-order first)
    #   e_k = omega(X_k^-1) / prod_{j!=k}(1 ^ X_j*X_k^-1)
    def conv_low(p, q):
        r = [0] * (len(p) + len(q) - 1)
        for a, pa in enumerate(p):
            for b, qb in enumerate(q):
                r[a + b] ^= _gmul(pa, qb)
        return r

    X = [_pow(2, cp) for cp in coef_pos]
    eloc_low = [1]
    for x in X:
        eloc_low = conv_low(eloc_low, [1, x])
    omega_low = conv_low(synd, eloc_low)[:n_err]

    def eval_low(p, y):
        acc = 0
        yp = 1
        for c in p:
            acc ^= _gmul(c, yp)
            yp = _gmul(yp, y) if yp else 0
        return acc

    out = list(msg)
    for k, p in enumerate(err_pos):
        xk_inv = _ginv(X[k])
        prod = 1
        for j in range(len(X)):
            if j != k:
                prod = _gmul(prod, 1 ^ _gmul(X[j], xk_inv))
        if prod == 0:
            return None
        mag = _gmul(eval_low(omega_low, xk_inv), _ginv(prod))
        out[p] ^= mag
    if max(_syndromes(out, nsym)) != 0:
        return None
    return bytes(out[:-nsym])


def _pow(a, nexp):
    if nexp == 0:
        return 1
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * nexp) % 255])


# ----------------------------------------------------------------------
# Generalized Reed-Solomon (parameterized field poly / first root / root
# gap) — the CCSDS configurations libcorrect exposes, e.g. the Falcon-9
# downlink's RS(255,239) with prim poly 0x187, fcr=120, gap=11
# (reference: decoder_modules/falcon9_decoder/src/falcon_fec.h:96).

class ReedSolomon:
    """RS(255, 255−nroots) over GF(256) with roots α^(fcr+i·gap).

    The gap≠1 case is solved by substitution: with β = α^gap (primitive
    when gcd(gap,255)=1) the syndromes S_i = Σ Y_k·Z_k^i are a standard
    BM problem over Z_k = X_k^gap with Y_k = e_k·X_k^fcr; positions
    come back through X_k = Z_k^(gap⁻¹ mod 255).
    """

    def __init__(self, nroots: int = 16, fcr: int = 120, gap: int = 11,
                 prim_poly: int = 0x187):
        assert math.gcd(gap, 255) == 1, gap
        self.nroots = int(nroots)
        self.fcr = int(fcr)
        self.gap = int(gap)
        self.exp = np.zeros(512, np.int32)
        self.log = np.zeros(256, np.int32)
        x = 1
        for i in range(255):
            self.exp[i] = x
            self.log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= prim_poly
        self.exp[255:510] = self.exp[:255]
        self.gap_inv = pow(gap, -1, 255)
        # generator polynomial (highest-order first)
        g = [1]
        for i in range(nroots):
            r = self._pow_a(fcr + i * gap)
            g = self._poly_mul(g, [1, r])
        self.gen = g

    # -- GF helpers -----------------------------------------------------
    def _mul(self, a, b):
        if a == 0 or b == 0:
            return 0
        return int(self.exp[(self.log[a] + self.log[b]) % 255])

    def _inv(self, a):
        return int(self.exp[(255 - self.log[a]) % 255])

    def _pow_a(self, e):
        return int(self.exp[e % 255])

    def _poly_mul(self, p, q):
        r = [0] * (len(p) + len(q) - 1)
        for i, a in enumerate(p):
            for j, b in enumerate(q):
                r[i + j] ^= self._mul(a, b)
        return r

    def _poly_eval(self, p, x):
        y = 0
        for c in p:
            y = self._mul(y, x) ^ int(c)
        return y

    # -- codec ----------------------------------------------------------
    def encode(self, data: bytes) -> bytes:
        assert len(data) == 255 - self.nroots
        rem = [0] * self.nroots
        for b in data:
            factor = b ^ rem[0]
            rem = rem[1:] + [0]
            if factor:
                for i in range(self.nroots):
                    rem[i] ^= self._mul(self.gen[i + 1], factor)
        return bytes(data) + bytes(rem)

    def decode(self, block: bytes) -> Optional[bytes]:
        msg = list(block)
        n = len(msg)
        assert n == 255
        synd = [self._poly_eval(msg, self._pow_a(self.fcr + i * self.gap))
                for i in range(self.nroots)]
        if max(synd) == 0:
            return bytes(block[:-self.nroots])

        # Berlekamp-Massey over Z (coefficients highest-order first)
        err_loc, old_loc = [1], [1]
        for i in range(self.nroots):
            old_loc.append(0)
            delta = synd[i]
            for j in range(1, len(err_loc)):
                delta ^= self._mul(err_loc[-(j + 1)], synd[i - j])
            if delta != 0:
                if len(old_loc) > len(err_loc):
                    new_loc = [self._mul(c, delta) for c in old_loc]
                    old_loc = [self._mul(c, self._inv(delta))
                               for c in err_loc]
                    err_loc = new_loc
                scaled = [self._mul(c, delta) for c in old_loc]
                r = [0] * max(len(err_loc), len(scaled))
                r[len(r) - len(err_loc):] = err_loc
                for k, c in enumerate(scaled):
                    r[k + len(r) - len(scaled)] ^= c
                err_loc = r
        while err_loc and err_loc[0] == 0:
            err_loc.pop(0)
        n_err = len(err_loc) - 1
        if n_err * 2 > self.nroots:
            return None

        # Chien search over Z = X^gap: codeword position p (0 = first
        # byte) has X = α^(n-1-p), Z = X^gap.
        Z, pos = [], []
        for p in range(n):
            xp = (n - 1 - p) % 255
            z = self._pow_a(xp * self.gap)
            if self._poly_eval(err_loc, self._inv(z)) == 0:
                Z.append(z)
                pos.append(p)
        if len(pos) != n_err:
            return None

        # Forney over Z (roots at Z_k⁻¹): Ω(x) = S(x)·Λ(x) mod x^n_err
        def conv_low(p, q):
            r = [0] * (len(p) + len(q) - 1)
            for a, pa in enumerate(p):
                for b, qb in enumerate(q):
                    r[a + b] ^= self._mul(pa, qb)
            return r

        eloc_low = [1]
        for z in Z:
            eloc_low = conv_low(eloc_low, [1, z])
        omega_low = conv_low(synd, eloc_low)[:n_err]

        def eval_low(p, y):
            acc, yp = 0, 1
            for c in p:
                acc ^= self._mul(c, yp)
                yp = self._mul(yp, y)
            return acc

        out = list(msg)
        for k, p in enumerate(pos):
            zk_inv = self._inv(Z[k])
            prod = 1
            for j in range(len(Z)):
                if j != k:
                    prod = self._mul(prod, 1 ^ self._mul(Z[j], zk_inv))
            if prod == 0:
                return None
            Yk = self._mul(eval_low(omega_low, zk_inv),
                           self._inv(prod))
            # e = Y / X^fcr with X = α^(n-1-p)
            xp = (n - 1 - p) % 255
            e = self._mul(Yk, self._inv(self._pow_a(xp * self.fcr)))
            out[p] ^= e
        synd2 = [self._poly_eval(out,
                                 self._pow_a(self.fcr + i * self.gap))
                 for i in range(self.nroots)]
        if max(synd2) != 0:
            return None
        return bytes(out[:-self.nroots])


def ccsds_randomizer(n: int = 255) -> np.ndarray:
    """CCSDS 131.0-B pseudo-randomizer bytes (x⁸+x⁷+x⁵+x³+1, all-ones
    seed) — reference falcon_fec.h randVals regenerated from the spec."""
    bits = [1] * 8
    for i in range(n * 8):
        bits.append(bits[i] ^ bits[i + 3] ^ bits[i + 5] ^ bits[i + 7])
    return np.array([int("".join(map(str, bits[i * 8:(i + 1) * 8])), 2)
                     for i in range(n)], np.uint8)


# CCSDS dual-basis (Berlekamp) transform: a GF(2)-linear map, generated
# from its 8 basis images (reference falcon_fec.h toDB/fromDB tables are
# exactly this map and its inverse).
_DUAL_BASIS_IMAGES = (0x7B, 0xAF, 0x99, 0xFA, 0x86, 0xEC, 0xEF, 0x8D)


def _dual_tables():
    to_db = np.zeros(256, np.uint8)
    for x in range(256):
        v = 0
        for k in range(8):
            if x & (1 << k):
                v ^= _DUAL_BASIS_IMAGES[k]
        to_db[x] = v
    from_db = np.zeros(256, np.uint8)
    from_db[to_db] = np.arange(256, dtype=np.uint8)
    return to_db, from_db


TO_DUAL_BASIS, FROM_DUAL_BASIS = _dual_tables()
