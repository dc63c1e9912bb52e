"""The polyphase WOLA channelizer, 2×-oversampled and critically sampled —
kernel K5 and its plain version (counterpart of
sdrplusplusbrown_tpu/ops/pallas_channelizer.py, whose V3 ``_chz3_kernel``
and the V2 / V1 forms compute this same function in both forms).

With s = [last K0 − h wideband samples | x | zeros], hop h and K0 = tpp·M,
every output frame F is one window of the stream:

    v_F[p]     = Σ_i br[p, i] · s[F·h + i·M + p]
    bins[m, F] = σ_{m,F} · Σ_p v_F[p] · e^{−2πi·mp/M}

  * 2×-oversampled (OversampledChannelizer, h = M/2): σ_{m,F} = (−1)^m on
    even frames and 1 on odd ones.  The even frames are the delayed pass
    of that block (its (−1)^m twiddle), the odd ones its plain pass.
  * critically sampled (PolyphaseChannelizer, h = M): σ = 1.  Frame F is
    the block's k = F output, v_F[p] = Σ_i br[p, i]·s[(F + i)·M + p], the
    history tpp − 1 whole rows of M samples.

The output is the stacked [2M, width] plane pair (re rows over im rows) in
the handoff storage dtype, or with a row list ``rows`` [R] (int32, each in
[0, 2M)) those rows of it, [R, width]: a channelized bank asks for the 2C
rows its channels gather.  Frames past T/h are garbage for the consumer to
ignore, as on the TPU: the plain version and the kernels up to M = 64
compute them from the zero-extended stream, the large-M kernel leaves the
columns past its last valid tile unwritten.  The branch taps and the DFT
matrix are float64 designs rounded to float32 and then to the handoff
dtype, where the JAX kernel rounds them.

Dispatch follows the input: CPU tensors run ``pfb_bins_ref``; CUDA
tensors launch csrc/pfb_channelizer.cu (``pfb_bins_kernel`` for the
oversampled form, ``pfb_critical_bins_kernel`` for the critical one) or
raise, also on a geometry the kernel cannot take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from .fir_kernel import SMEM_MAX, SMS
from .precision import get_handoff_dtype, round_to

_STORAGE = (torch.float32, torch.bfloat16)
PFB_NF = 8           # frames a thread folds (csrc/pfb_channelizer.cu)
# (frames a tile, input spans in shared memory; 0: read in place), in the
# order tried: the warp-specialised kernel's, then the other's
PFB_WS_TILES = ((32, 1), (16, 2), (16, 1), (16, 0))
PFB_TILES = ((32, 2), (32, 1), (16, 2), (16, 1), (16, 0))
SM_SMEM = 233_472    # shared memory of one SM (228 KB)


def pfb_smem(M: int, tpp: int, h: int, nt: int, nbuf: int,
             nbs: int = 1) -> int:
    """Shared-memory bytes of one K5 block up to M = 64 (csrc/
    pfb_channelizer.cu:pfb_layout): the transposed taps, ``nbuf`` input
    spans of both planes, ``nbs`` buffers of a tile's folded frames as three
    bf16 parts [nt, 2M padded to 16 + 8] and the output tile [2M padded,
    nt + 8] float32."""
    KP = -(-2 * M // 16) * 16
    SC = (((nt - 1) * h + tpp * M + M + 3) & ~3) + 4
    words = ((tpp * M + 3) & ~3) + nbuf * 2 * SC \
        + nbs * 3 * nt * (KP // 2 + 4) + KP * (nt + 8)
    return 4 * words


def pfb_big_smem(M: int, tpp: int, h: int, nt: int, kc: int, rbp: int,
                 na: int, staged: bool, wg: bool, ring: int,
                 threads: int) -> int:
    """Shared-memory bytes of one large-M block (csrc/pfb_channelizer.cu:
    big_layout): the mbarriers, the block's ``rbp`` row ids, the
    transposed taps, the input span of both planes where ``staged``,
    ``ring`` slots of the rows' ``kc``-wide k-slices (``na`` bf16 parts,
    rows of kc + 8), two frame buffers (three bf16 parts, kc / 8 k groups of
    nt·16 + 16 bytes) and, on mma.sync (not ``wg``) with fewer (m-tile,
    n-tile) pairs than the block's ``threads`` / 32 warps, each pair's
    k-step accumulators."""
    def r16(n):
        return (n + 15) & ~15
    SC = (((nt - 1) * h + tpp * M + M + 3) & ~3) + 4
    npair = rbp // 16 * (nt // 8)
    return (64 + r16(4 * rbp) + r16(4 * tpp * M) + (8 * SC if staged else 0)
            + ring * na * rbp * (kc + 8) * 2
            + 2 * 3 * kc // 8 * (nt * 16 + 16)
            + (npair * (kc // 16) * 512
               if not wg and npair < threads // 32 else 0))


#: M above which the DFT matrix leaves the fragment registers: the
#: large-M kernel, pfb_big_kernel
PFB_REG_M = 64
#: rows of the list from which the large-M kernel runs wgmma (two
#: warpgroups' 64-row sides); below, mma.sync
PFB_WG_ROWS = 128
#: the large-M kernel's frames a tile on mma.sync, in the order tried
PFB_BIG_TILES = (64, 32, 16)
#: slots of its ring of row slices at most (its mbarriers' room)
PFB_MAX_RING = 7


def _big_plan(M: int, tpp: int, h: int, width: int, na: int, R: int,
              n_valid: int) -> dict:
    """The large-M kernel's grid: tiles of ``nt`` frames over the
    ``n_valid`` valid frames only (blockIdx.x) times groups of ``rbp``
    rows of the list (blockIdx.y), every block folding its tile.

      * From PFB_WG_ROWS rows, wgmma: nt 64 (the N side), rbp 256 (two
        warpgroups, two 64-row sides each), k-chunks of 64 (one-part
        matrix) or 16 (three parts: the chunk's A fragments stay in
        registers, and its ring leaves room for the staged span).
      * Below, mma.sync: rbp 32 or 16 and nt 64, 32 or 16, the first pair
        (most rows a block, each block folding its tile once; then the
        largest tile) whose blocks fill the SMs, else the most blocks (16
        and 16); k-chunks of 4096 / nt (a k row and a run of 8 frames an
        item), or 2048 / nt where the blocks outnumber
        the SMs and only the smaller chunk lets two blocks share an SM.
        ``threads``: 512 where the blocks fit one wave at one an SM
        (twice the warps to hide the fold's latencies), else 256 (two
        blocks an SM where their shared memory fits).
        ``scripts/pfb_big_ab.py --plans`` ranks every alternative.

    The input span is staged in shared memory where it fits beside the
    rest (``staged``; read in place it cost the critical form 2.4×), with
    a slot of row slices for every chunk where they fit (``ring``: all
    copied at the block's start, off its chunks' critical path), else a
    ring of two (each chunk's copied a chunk ahead; three and four slots
    measured no faster, scripts/pfb_big_ab.py --plans); raises where not
    even the unstaged block fits SMEM_MAX."""
    wg = R >= PFB_WG_ROWS
    if wg:
        nt, rbp, kc = 64, 256, (64 if na == 1 else 16)
    else:
        nt, rbp = PFB_BIG_TILES[-1], 16
        for rb, cand in ((rb, cand) for rb in ((32, 16) if R > 16 else (16,))
                         for cand in PFB_BIG_TILES):
            if -(-n_valid // cand) * -(-R // rb) >= SMS:
                nt, rbp = cand, rb
                break
    tiles = min(-(-n_valid // nt), -(-width // nt))
    rgroups = -(-R // rbp)
    threads = 512 if not wg and tiles * rgroups <= SMS else 256
    KP = -(-2 * M // 16) * 16
    # k-chunks no wider than the matrix (a power of two)
    kp2 = 1 << (KP - 1).bit_length()
    kcs = (kc,) if wg else tuple(dict.fromkeys(
        min(k, kp2) for k in (4096 // nt, 2048 // nt)))
    # (kc, staged, ring): every chunk's slices resident (copied at the
    # start) where they fit, else a ring of two
    fits = [(k, staged, ring) for staged in (True, False) for k in kcs
            for ring in sorted({max(2, min(-(-KP // k), PFB_MAX_RING)), 2},
                               reverse=True)
            if pfb_big_smem(M, tpp, h, nt, k, rbp, na, staged, wg, ring,
                            threads) <= SMEM_MAX]
    if not fits:
        raise NotImplementedError(f"PFB kernel geometry M={M}, tpp={tpp} "
                                  f"does not fit {SMEM_MAX} bytes")
    two = [f for f in fits if 2 * (pfb_big_smem(
        M, tpp, h, nt, f[0], rbp, na, f[1], wg, f[2], threads) + 1024)
        <= SM_SMEM]
    kc, staged, ring = two[0] if tiles * rgroups > SMS and two and \
        two[0][1] == fits[0][1] else fits[0]
    smem = pfb_big_smem(M, tpp, h, nt, kc, rbp, na, staged, wg, ring,
                        threads)
    return {"ws": False, "big": True, "wg": wg, "nt": nt, "kc": kc,
            "rbp": rbp, "staged": staged, "ring": ring,
            "threads": threads, "smem": smem,
            "tiles": tiles, "rgroups": rgroups, "blocks": tiles * rgroups,
            "per_sm": 1 if threads == 512 else
            min(2, SM_SMEM // (smem + 1024)),
            "launches": 1}


def pfb_plan(M: int, tpp: int, h: int, width: int, na: int = 1,
             R: int | None = None, n_valid: int | None = None) -> dict:
    """K5's grid (csrc/pfb_channelizer.cu).  Up to M = ``PFB_REG_M``:
    persistent blocks walking tiles of ``nt`` frames (32, or 16 where 32
    does not fit).  With a one-part DFT matrix (``na`` = 1, the bf16
    handoff) the warp-specialised kernel (``ws``: four warps fold the next
    tile into one of two frame buffers while four multiply this one), two
    blocks an SM where they fit.  With three parts every warp takes every
    phase in turn (96 registers of matrix fragments a thread: one block an
    SM), two input spans where they fit (the next tile's arrives while this
    one works).  Either kernel takes no span (``nbuf`` 0) where not even
    one fits: the fold then reads the stream, laid out whole, in place
    (thousands of taps a branch).  Every block walks tiles blockIdx,
    blockIdx + grid, ...; raises where no tile fits SMEM_MAX.

    Above (``big``): the large-M kernel on ``R`` rows of the plane (default
    all 2M) and the tiles that hold the ``n_valid`` valid frames (default
    ``width``): ``_big_plan``."""
    if M > PFB_REG_M:
        return _big_plan(M, tpp, h, width, na, 2 * M if R is None else R,
                         width if n_valid is None else n_valid)
    ws = na == 1
    for nt, nbuf in PFB_WS_TILES if ws else PFB_TILES:
        smem = pfb_smem(M, tpp, h, nt, nbuf, 2 if ws else 1)
        if smem <= SMEM_MAX:
            break
    else:
        raise NotImplementedError(f"PFB kernel geometry M={M}, tpp={tpp} "
                                  f"does not fit {SMEM_MAX} bytes")
    tiles = -(-width // nt)
    # two blocks an SM but for the three-part kernel's 96 fragment
    # registers a thread
    per_sm = min(1 if na == 3 else 2, SM_SMEM // (smem + 1024))
    grid = min(tiles, SMS * per_sm)
    return {"ws": ws, "big": False, "nt": nt, "nbuf": nbuf, "smem": smem,
            "tiles": tiles, "per_sm": per_sm, "grid": grid, "launches": 1}


#: the bf16 products the kernel sums into each bin, smallest first: (matrix
#: part, frame part) for a matrix of one part and of three
MMA_PASSES = {1: ((0, 2), (0, 1), (0, 0)),
              3: ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))}


def split_bf16(a: torch.Tensor, parts: int = 3) -> list:
    """float32 ``a`` as ``parts`` bf16 tensors whose float32 sum is ``a``
    (exactly, for three parts): each the round-to-nearest-even of what the
    earlier ones leave (the kernel's split of the folded frames)."""
    out, r = [], a.float()
    for _ in range(parts):
        b = r.to(torch.bfloat16)
        out.append(b)
        r = r - b.float()
    return out


def dft_matrix(cm: torch.Tensor, sm: torch.Tensor) -> torch.Tensor:
    """[[C, S], [−S, C]] float32 [2M, 2M]: [re; im] = it · [vr; vi]."""
    return torch.cat([torch.cat([cm, sm], dim=1),
                      torch.cat([-sm, cm], dim=1)]).float()


class PFBChannelizer:
    """K5 configuration built from an OversampledChannelizer: hop M/2, the
    (−1)^m sign on even frames, the block's {tail_a, tail_b, delay} state
    dict."""

    critical = False

    def __init__(self, chz):
        self.M = M = int(chz.M)
        self.h = M if self.critical else M // 2
        self.tpp = int(chz.tpp)
        self.K0 = self.tpp * M
        self.branches = np.asarray(chz.branches, np.float32)     # [M, tpp]
        ang = 2.0 * np.pi * np.outer(np.arange(M), np.arange(M)) / M
        self.cos = np.cos(ang).astype(np.float32)
        self.sin = np.sin(ang).astype(np.float32)
        self._dev = {}

    @property
    def n_hist(self) -> int:
        """Wideband samples carried between calls (K0 − h)."""
        return self.K0 - self.h

    def check_kernel_geometry(self) -> None:
        """Raise unless csrc/pfb_channelizer.cu takes this geometry: even
        M (above ``PFB_REG_M`` the large-M kernel) and at least two taps
        per branch (``pfb_plan`` raises where no tile fits)."""
        if self.tpp < 2 or self.M % 2:
            raise NotImplementedError(
                f"PFB kernel geometry M={self.M}, tpp={self.tpp}")

    def dft_parts(self, device, dtype):
        """(bf16 [na, KP, KP] device tensor, na): the DFT matrix
        ``dft_matrix`` of the ``dtype``-rounded cos and sin, zero-padded to
        KP = 2M rounded up to 16, split into bf16 parts (``split_bf16``) for
        the kernel's tensor cores; one part where the matrix is exact in
        bf16 (the other parts are zero), else three."""
        key = ("parts", str(device), dtype)
        if key not in self._dev:
            cm, sm = (round_to(torch.from_numpy(a), dtype)
                      for a in (self.cos, self.sin))
            KP = -(-2 * self.M // 16) * 16
            A = torch.zeros((KP, KP), dtype=torch.float32)
            A[:2 * self.M, :2 * self.M] = dft_matrix(cm, sm)
            parts = split_bf16(A)
            na = 1 if not (parts[1].float().any() or parts[2].float().any()) \
                else 3
            self._dev[key] = (torch.stack(parts[:na]).to(device).contiguous(),
                              na)
        return self._dev[key]

    def chunked_parts(self, device, dtype, kc: int):
        """(bf16 [na, ceil(KP / kc), KP, kc + 8] device tensor, na): the
        ``dft_parts`` by k-chunk for the large-M kernel: chunk c holds
        columns c·kc .. c·kc + kc of every row, then 8 zero columns (its
        shared-memory row pitch), columns past KP zero; one row's slice, or
        a run of consecutive rows' slices, is one contiguous copy."""
        key = ("chunks", str(device), dtype, kc)
        if key not in self._dev:
            parts, na = self.dft_parts(device, dtype)
            KP = parts.shape[-1]
            nch = -(-KP // kc)
            c = torch.zeros((na, nch, KP, kc + 8), dtype=torch.bfloat16,
                            device=device)
            for i in range(nch):
                w = min(kc, KP - i * kc)
                c[:, i, :, :w] = parts[:, :, i * kc:i * kc + w]
            self._dev[key] = (c.contiguous(), na)
        return self._dev[key]

    def all_rows(self, device) -> torch.Tensor:
        """int32 [2M] 0 .. 2M − 1 on ``device`` (the whole plane as a row
        list), made once."""
        key = ("rows", str(device))
        if key not in self._dev:
            self._dev[key] = torch.arange(2 * self.M, dtype=torch.int32,
                                          device=device)
        return self._dev[key]

    def operands(self, device, dtype):
        """(branches [M, tpp], cos [M, M], sin [M, M]) float32 device
        tensors rounded to the storage ``dtype``."""
        key = (str(device), dtype)
        if key not in self._dev:
            self._dev[key] = tuple(
                round_to(torch.from_numpy(a), dtype).to(device).contiguous()
                for a in (self.branches, self.cos, self.sin))
        return self._dev[key]

    # ---- OversampledChannelizer state <-> the last n_hist samples -------
    def state_to_xw(self, state) -> torch.Tensor:
        tb = state["tail_b"].transpose(-1, -2).reshape(
            state["tail_b"].shape[:-2] + ((self.tpp - 1) * self.M,))
        return torch.cat([tb, state["delay"]], dim=-1)

    def xw_to_state(self, xw: torch.Tensor) -> dict:
        n, M, h = (self.tpp - 1) * self.M, self.M, self.h
        lead = xw.shape[:-1]
        return {"tail_a": xw[..., h:h + n].reshape(lead + (self.tpp - 1, M))
                .transpose(-1, -2).contiguous(),
                "tail_b": xw[..., :n].reshape(lead + (self.tpp - 1, M))
                .transpose(-1, -2).contiguous(),
                "delay": xw[..., n:n + h].contiguous()}

    def apply(self, state, x, width_out: int, out_dtype=None,
              tap_dtype=None, rows=None):
        """x: (xr, xi) float32 [T] planes → (bins [2M, width_out] in
        ``out_dtype`` (default: the handoff dtype), or with ``rows`` those
        rows, [R, width_out]; state'); the taps rounded to ``tap_dtype``
        (default: the handoff dtype)."""
        h_dt = get_handoff_dtype()
        out_dtype = h_dt if out_dtype is None else out_dtype
        tap_dtype = h_dt if tap_dtype is None else tap_dtype
        xr, xi = x
        xr = xr.float().contiguous()
        xi = xi.float().contiguous()
        xw = self.state_to_xw(state)
        bins = pfb_bins(self, xr, xi, xw.real.contiguous(),
                        xw.imag.contiguous(), width_out, tap_dtype, out_dtype,
                        rows)
        return bins, self.next_state(xw, xr, xi)

    def next_state(self, xw, xr, xi):
        """The state after a call on (xr, xi) from history ``xw``: the
        last n_hist samples of [xw | x], in the block's layout."""
        T, nh = xr.shape[-1], self.n_hist
        tail = (torch.complex(xr[T - nh:], xi[T - nh:]) if T >= nh
                else torch.cat([xw, torch.complex(xr, xi)])[-nh:])
        return self.xw_to_state(tail)


class PFBCritical(PFBChannelizer):
    """K5's critically sampled configuration, built from a
    PolyphaseChannelizer: hop M, no sign, the block's [M, tpp − 1] branch
    history (column j of row p is sample j·M + p of the last (tpp − 1)·M),
    converted exactly as the JAX package's ``PallasPolyChannelizer`` does."""

    critical = True

    def state_to_xw(self, state) -> torch.Tensor:
        return state.transpose(-1, -2).reshape(
            state.shape[:-2] + ((self.tpp - 1) * self.M,))

    def xw_to_state(self, xw: torch.Tensor) -> torch.Tensor:
        return xw.reshape(xw.shape[:-1] + (self.tpp - 1, self.M)) \
            .transpose(-1, -2).contiguous()


def _check_pfb(pipe, xr, xi, xwr, xwi, width_out, rows=None):
    T = xr.shape[-1]
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be 1-D planes of one length")
    if T % pipe.M:
        raise ValueError(f"block length {T} not a multiple of M={pipe.M}")
    if xwr.shape != (pipe.n_hist,) or xwi.shape != (pipe.n_hist,):
        raise ValueError(f"history planes must hold {pipe.n_hist} samples")
    if width_out < T // pipe.h:
        raise ValueError(f"width {width_out} < {T // pipe.h} frames")
    if rows is not None and (rows.dim() != 1 or rows.dtype != torch.int32
                             or not 1 <= rows.shape[0] <= 2 * pipe.M):
        raise ValueError(f"rows: an int32 list of 1 to {2 * pipe.M} rows")
    return T


def pfb_bins_ref(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                 out_dtype, rows=None) -> torch.Tensor:
    """Plain PyTorch K5, either form: bins [2M, width_out] in
    ``out_dtype``, or with ``rows`` those rows of them, [R, width_out]."""
    T = _check_pfb(pipe, xr, xi, xwr, xwi, width_out, rows)
    M, h, K0, tpp = pipe.M, pipe.h, pipe.K0, pipe.tpp
    br, cm, sm = pipe.operands(xr.device, tap_dtype)
    need = (width_out - 1) * h + K0
    pad = max(0, need - pipe.n_hist - T)
    planes = []
    for hist, xx in ((xwr, xr), (xwi, xi)):
        s = torch.cat([hist.float(), xx.float(),
                       torch.zeros(pad, device=xx.device)])
        win = s.unfold(0, K0, h)[:width_out].reshape(width_out, tpp, M)
        planes.append((win * br.t()[None]).sum(dim=1))        # [W, M]
    vr, vi = planes
    re = vr @ cm.t() + vi @ sm.t()
    im = vi @ cm.t() - vr @ sm.t()
    if not pipe.critical:
        sgn = torch.where(torch.arange(M, device=xr.device) % 2 == 0,
                          1.0, -1.0)
        even = (torch.arange(width_out, device=xr.device) % 2 == 0)[:, None]
        re = torch.where(even, re * sgn, re)
        im = torch.where(even, im * sgn, im)
    out = torch.cat([re.t(), im.t()])
    if rows is not None:
        out = out[rows.long()]
    return out.to(out_dtype).contiguous()


def _launch_pfb(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                out_dtype, rows=None, probe: bool = False,
                plan: dict | None = None, out: torch.Tensor | None = None):
    """One launch of csrc/pfb_channelizer.cu, either form, on ``plan``
    (default ``pfb_plan``'s): the bins, and with ``probe`` (bins, the
    folded frames v_F float32 [2M, width_out], unsigned).  On a large-M
    plan (above M = 64, or a ``_big_plan`` given at any M) ``rows``
    (default: all 2M) picks the rows, only the tiles holding the T/h valid
    frames are computed and ``out`` (a tensor of the result's shape, dtype
    and device) may take the bins in place of a new one: its columns past
    those tiles keep what they held."""
    dev = xr.device
    f32 = torch.float32
    T = _check_pfb(pipe, xr, xi, xwr, xwi, width_out, rows)
    if out_dtype not in _STORAGE:
        raise ValueError(f"output dtype {out_dtype}")
    pipe.check_kernel_geometry()
    br = pipe.operands(dev, tap_dtype)[0]
    parts, na = pipe.dft_parts(dev, tap_dtype)
    fold = torch.empty((2 * pipe.M, width_out), dtype=f32, device=dev) \
        if probe else None
    head = (_build.check(xr, "xr", f32, device=dev),
            _build.check(xi, "xi", f32, (T,), dev), T,
            _build.check(xwr, "history re", f32, device=dev),
            _build.check(xwi, "history im", f32, device=dev), pipe.n_hist,
            _build.check(br, "branch taps", f32, device=dev),
            _build.check(parts, "dft parts", torch.bfloat16, device=dev), na,
            pipe.M, pipe.tpp, pipe.h, int(not pipe.critical))
    R = 2 * pipe.M if rows is None else rows.shape[0]
    plan = plan or pfb_plan(pipe.M, pipe.tpp, pipe.h, width_out, na, R,
                            T // pipe.h)
    if not plan["big"]:
        if rows is not None or out is not None:
            raise ValueError("a row list needs the large-M kernel "
                             f"(M > {PFB_REG_M})")
        ext = (None, None)
        if plan["nbuf"] == 0:   # s whole, through the last tile's span + M
            need = (plan["tiles"] * plan["nt"] - 1) * pipe.h + pipe.K0 \
                + pipe.M
            pad = torch.zeros(max(0, need - pipe.n_hist - T), device=dev)
            ext = tuple(torch.cat([h, x, pad]) for h, x in ((xwr, xr),
                                                             (xwi, xi)))
        out = torch.empty((2 * pipe.M, width_out), dtype=out_dtype,
                          device=dev)
        _build.launch(
            "sdr_pfb_bins", dev, *head, out.data_ptr(),
            int(out_dtype == torch.bfloat16), width_out, int(plan["ws"]),
            plan["nt"], plan["nbuf"], plan["grid"],
            *(None if e is None else e.data_ptr() for e in ext),
            None if fold is None else fold.data_ptr())
        return (out, fold) if probe else out
    if rows is None:
        rows = pipe.all_rows(dev)
    if out is None:
        out = torch.empty((R, width_out), dtype=out_dtype, device=dev)
    chunks = pipe.chunked_parts(dev, tap_dtype, plan["kc"])[0]
    _build.launch(
        "sdr_pfb_big", dev, *head[:7],
        _build.check(chunks, "dft parts by chunk", torch.bfloat16,
                     device=dev), *head[8:],
        _build.check(rows, "rows", torch.int32, (R,), dev), R,
        _build.check(out, "bins", out_dtype, (R, width_out), dev),
        int(out_dtype == torch.bfloat16), width_out, int(plan["wg"]),
        plan["nt"], plan["kc"], plan["rbp"], int(plan["staged"]),
        plan["ring"], plan["threads"], plan["tiles"], plan["rgroups"],
        None if fold is None else fold.data_ptr())
    return (out, fold) if probe else out


@_build.counted
def pfb_bins_kernel(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                    out_dtype, rows=None) -> torch.Tensor:
    """K5 on the card, 2×-oversampled form; same contract as
    ``pfb_bins_ref`` (columns past the valid tiles unwritten above
    M = 64)."""
    if pipe.critical:
        raise ValueError("a critically sampled PFB: pfb_critical_bins_kernel")
    return _launch_pfb(pipe, xr, xi, xwr, xwi, width_out, tap_dtype,
                       out_dtype, rows)


@_build.counted
def pfb_critical_bins_kernel(pipe, xr, xi, xwr, xwi, width_out: int,
                             tap_dtype, out_dtype, rows=None) -> torch.Tensor:
    """K5 on the card, critically sampled form (hop M, no sign); same
    contract as ``pfb_bins_ref``."""
    if not pipe.critical:
        raise ValueError("a 2×-oversampled PFB: pfb_bins_kernel")
    return _launch_pfb(pipe, xr, xi, xwr, xwi, width_out, tap_dtype,
                       out_dtype, rows)


#: the plain version of the critical form is ``pfb_bins_ref``
pfb_critical_bins_ref = pfb_bins_ref


def pfb_bins(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype, out_dtype,
             rows=None):
    """K5 dispatch: the form's kernel for CUDA tensors, the plain version
    for CPU tensors; ``rows`` as ``pfb_bins_ref``'s."""
    if not xr.is_cuda:
        fn = pfb_bins_ref
    elif pipe.critical:
        fn = pfb_critical_bins_kernel
    else:
        fn = pfb_bins_kernel
    return fn(pipe, xr, xi, xwr, xwi, width_out, tap_dtype, out_dtype, rows)
