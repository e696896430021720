"""rANS entropy coder (host-side, numpy) for the ECSQ symbol streams.

The paper's rate accounting is the entropy H_Q of the quantized messages,
"achievable through entropy coding". This module provides the actual coder so
the claim is *demonstrated*, not assumed: tests check

    H_Q * n  <=  len(bitstream)  <=  H_hat * n + overhead,

with overhead a few bytes (state flush + table). Static-model range-variant
ANS (rANS) with 12-bit quantized frequencies and byte renormalization.

The coder runs on the host: the device transports emulate the wire at
fixed width (ECSQ symbols, int8/int4 blocks) and the solve service codes a
request's symbol streams here when it asks for measured wire bytes
(``serving.wire.measure_wire``). The JAX package's
``repro.core.entropy_code``, kept as it is: the byte counts are the same.
"""
from __future__ import annotations

import numpy as np

__all__ = ["RansCodec"]

_SCALE_BITS = 12
_SCALE = 1 << _SCALE_BITS
_RANS_L = 1 << 23          # lower bound of the normalization interval
_MASK = (1 << 32) - 1


def _quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Quantize symbol counts to frequencies summing to 2^12, all >= 1."""
    counts = np.asarray(counts, dtype=np.float64)
    if counts.sum() <= 0:
        raise ValueError("empty model")
    if len(counts) > _SCALE:
        # every symbol needs a frequency slot >= 1, so an alphabet larger
        # than the frequency scale cannot be normalized: the adjustment
        # loop below would spin forever trying to shed an irreducible
        # surplus. ECSQ alphabets here are ~2*clip/delta, far below 4096.
        raise ValueError(
            f"alphabet of {len(counts)} symbols exceeds the rANS frequency "
            f"scale ({_SCALE}); re-bin the symbols or raise _SCALE_BITS")
    freqs = np.maximum(1, np.round(counts / counts.sum() * _SCALE)).astype(np.int64)
    # fix rounding drift by adjusting the largest entries
    diff = int(freqs.sum() - _SCALE)
    while diff != 0:
        idx = int(np.argmax(freqs)) if diff > 0 else int(np.argmax(counts - freqs))
        step = min(abs(diff), max(int(freqs[idx]) - 1, 1)) * (1 if diff > 0 else -1)
        if diff > 0 and freqs[idx] - step < 1:
            step = freqs[idx] - 1
        freqs[idx] -= step if diff > 0 else -abs(step)
        diff = int(freqs.sum() - _SCALE)
    return freqs


class RansCodec:
    """Static-model rANS over a contiguous alphabet [0, n_symbols)."""

    def __init__(self, counts: np.ndarray):
        self.freqs = _quantize_freqs(counts)
        self.cum = np.zeros(len(self.freqs) + 1, dtype=np.int64)
        np.cumsum(self.freqs, out=self.cum[1:])
        # decoding table: slot -> symbol
        self.slot2sym = np.repeat(np.arange(len(self.freqs)), self.freqs).astype(np.int64)

    def encode(self, symbols: np.ndarray) -> bytes:
        """Encode int symbols (values in [0, n_symbols)). Returns bytestream."""
        syms = np.asarray(symbols, dtype=np.int64).ravel()
        freqs, cum = self.freqs, self.cum
        out = bytearray()
        x = _RANS_L
        # encode in reverse so the decoder emits in forward order
        for s in syms[::-1]:
            f = int(freqs[s])
            # renormalize: keep x < (L/scale) * 256 * f after the step
            x_max = ((_RANS_L >> _SCALE_BITS) << 8) * f
            while x >= x_max:
                out.append(x & 0xFF)
                x >>= 8
            x = ((x // f) << _SCALE_BITS) + (x % f) + int(cum[s])
        for _ in range(4):
            out.append(x & 0xFF)
            x >>= 8
        return bytes(out[::-1])

    def decode(self, data: bytes, n: int) -> np.ndarray:
        freqs, cum, slot2sym = self.freqs, self.cum, self.slot2sym
        pos = 0
        x = 0
        for _ in range(4):
            x = (x << 8) | data[pos]
            pos += 1
        out = np.empty(n, dtype=np.int64)
        for i in range(n):
            slot = x & (_SCALE - 1)
            s = int(slot2sym[slot])
            out[i] = s
            x = int(freqs[s]) * (x >> _SCALE_BITS) + slot - int(cum[s])
            while x < _RANS_L and pos < len(data):
                x = (x << 8) | data[pos]
                pos += 1
        return out

    def encoded_bits(self, symbols: np.ndarray) -> int:
        return 8 * len(self.encode(symbols))
