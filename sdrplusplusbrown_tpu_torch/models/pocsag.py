"""POCSAG pager decoder — an end-to-end digital decoder built from the
framework's primitives (GFSK demod → slicer → frame sync → BCH → text;
counterpart of sdrplusplusbrown_tpu/models/pocsag.py, host numpy past
the demod, as in the JAX package).

reference: decoder_modules/pager_decoder (the fork ships a POCSAG/
FLEX pager decoder as one of its decoder-module families).  Implemented
from the public POCSAG specification (ITU-R M.584): 2-FSK ±4.5 kHz at
512/1200/2400 baud; 576-bit 1010 preamble; 32-bit codewords in batches
of one sync word (0x7CD215D8) + 8 frames × 2 codewords; each codeword
is 1 flag + 20 data bits + 10 BCH(31,21) check bits + even parity.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

SYNC_WORD = 0x7CD215D8
IDLE_WORD = 0x7A89C197
_BCH_GEN = 0b11101101001          # g(x) = x^10+x^9+x^8+x^6+x^5+x^3+1


def _bch_syndrome(word31: int) -> int:
    reg = word31
    for bit in range(30, 9, -1):
        if reg & (1 << bit):
            reg ^= _BCH_GEN << (bit - 10)
    return reg & 0x3FF


def check_codeword(cw: int) -> Optional[int]:
    """Validate/correct one 32-bit codeword; returns the corrected word
    or None.  BCH(31,21) detection with brute-force 1-bit correction plus
    the even-parity bit."""
    def ok(w):
        return _bch_syndrome(w >> 1) == 0 and bin(w).count("1") % 2 == 0

    if ok(cw):
        return cw
    for i in range(32):
        c = cw ^ (1 << i)
        if ok(c):
            return c
    return None


def encode_codeword(data21: int) -> int:
    """21 data bits (flag+20) → 32-bit codeword with BCH + parity."""
    word31 = (data21 << 10) | _bch_syndrome(data21 << 10)
    parity = bin(word31).count("1") % 2
    return (word31 << 1) | parity


def encode_address(address: int, function: int = 0) -> int:
    # flag=0, high 18 address bits, 2 function bits (the low 3 address
    # bits select the frame slot instead)
    data21 = ((address >> 3) & 0x3FFFF) << 2 | (function & 3)
    return encode_codeword(data21 & 0x1FFFFF)


def encode_message_words(text: str) -> List[int]:
    """7-bit ASCII packed LSB-first into 20-bit message codewords."""
    bits: List[int] = []
    for ch in text:
        c = ord(ch) & 0x7F
        bits.extend((c >> i) & 1 for i in range(7))   # LSB first
    while len(bits) % 20:
        bits.append(0)
    words = []
    for i in range(0, len(bits), 20):
        d = 0
        for b in bits[i:i + 20]:
            d = (d << 1) | b
        words.append(encode_codeword((1 << 20) | d))  # flag=1: message
    return words


def encode_transmission(address: int, text: str,
                        function: int = 0) -> np.ndarray:
    """Full bit stream: preamble + batches (sync + 16 codewords)."""
    frame = (address >> 0) & 7
    words = [encode_address(address, function)] + encode_message_words(text)
    bits: List[int] = [1, 0] * 288                     # 576-bit preamble
    slot = frame * 2
    batch: List[int] = []
    while words or batch:
        cws = [IDLE_WORD] * 16
        i = slot
        while words and i < 16:
            cws[i] = words.pop(0)
            i += 1
        slot = 0
        batch = []
        stream = [SYNC_WORD] + cws
        for w in stream:
            bits.extend((w >> b) & 1 for b in range(31, -1, -1))
        if not words:
            break
    # trailing idle batch terminates the last message even when it filled
    # its batch exactly
    for w in [SYNC_WORD] + [IDLE_WORD] * 16:
        bits.extend((w >> b) & 1 for b in range(31, -1, -1))
    return np.array(bits, np.uint8)


# ----------------------------------------------------------------------
class POCSAGDecoder:
    """Bit-stream decoder: sync search (both polarities) → batches →
    address/message extraction → 7-bit text."""

    def __init__(self):
        self.messages: List[dict] = []
        self._bits: List[int] = []
        # message continuation across batches: an address opens a message
        # that keeps accumulating until the next address/idle codeword
        self._cur_addr: Optional[int] = None
        self._cur_bits: List[int] = []

    def push_bits(self, bits):
        self._bits.extend(int(b) & 1 for b in np.asarray(bits).reshape(-1))
        self._scan()

    def _word_at(self, pos: int) -> int:
        w = 0
        for b in self._bits[pos:pos + 32]:
            w = (w << 1) | b
        return w

    def _scan(self):
        # search for sync in either polarity
        n = len(self._bits)
        pos = 0
        consumed = 0
        while pos + 32 * 17 <= n:
            w = self._word_at(pos)
            inv = (~w) & 0xFFFFFFFF
            # tolerate up to 2 bit errors in the sync word
            if bin(w ^ SYNC_WORD).count("1") <= 2:
                self._decode_batch(pos + 32, 0)
                pos += 32 * 17
                consumed = pos
            elif bin(inv ^ SYNC_WORD).count("1") <= 2:
                self._decode_batch(pos + 32, 0xFFFFFFFF)
                pos += 32 * 17
                consumed = pos
            else:
                pos += 1
        if consumed:
            self._bits = self._bits[consumed:]
        elif len(self._bits) > 32 * 40:
            self._bits = self._bits[-32 * 20:]

    def _flush_message(self):
        if self._cur_addr is not None:
            self.messages.append({
                "address": self._cur_addr,
                "text": self._bits_to_text(self._cur_bits)})
        self._cur_addr = None
        self._cur_bits = []

    def _decode_batch(self, pos: int, flip: int):
        for i in range(16):
            cw = self._word_at(pos + i * 32) ^ flip
            fixed = check_codeword(cw)
            if fixed is None:
                continue
            if fixed == IDLE_WORD:
                # idle terminates the current message (spec: messages run
                # until the next address or idle codeword)
                self._flush_message()
                continue
            data21 = fixed >> 11
            if data21 & (1 << 20):          # message codeword
                if self._cur_addr is None:
                    continue                 # orphan, no open message
                d20 = data21 & 0xFFFFF
                self._cur_bits.extend((d20 >> b) & 1
                                      for b in range(19, -1, -1))
            else:                            # address codeword
                self._flush_message()
                addr_hi = (data21 >> 2) & 0x3FFFF
                frame = i // 2
                self._cur_addr = (addr_hi << 3) | frame

    @staticmethod
    def _bits_to_text(bits: List[int]) -> str:
        out = []
        for i in range(0, len(bits) - 6, 7):
            c = 0
            for b in range(7):               # LSB-first within the char
                c |= bits[i + b] << b
            if c == 0:
                continue
            if 32 <= c < 127:
                out.append(chr(c))
        return "".join(out)
