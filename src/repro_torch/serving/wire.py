"""Bytes on the wire: measured rANS accounting (the measured half of the
JAX package's ``repro.serving.wire``, kept as it is; its DESIGN.md §10).

The paper's rate numbers are model entropies H_Q, "achievable through
entropy coding". When a request opts in (``SolveRequest.measure_wire``),
each round's per-processor quantizer symbol stream from the engine trace is
actually rANS-coded (``core.entropy_code.RansCodec``, static per-stream
model) on the host and the *measured* byte count is reported next to the
model rate. (The reference's TCP frame transport, the other half of its
module, belongs to the cluster tier: ROADMAP.md Queue 1 item 6.)

Accounting per (round, processor) packet:

  * coded rounds (finite bin size): rANS payload bytes + the model cost of
    shipping the static table (12-bit quantized frequencies per alphabet
    symbol + a 4-byte symbol offset) + the link-layer header,
  * lossless rounds: raw fixed-width payload (``WireModel.lossless_bits``
    per element — the paper's 32-bit baseline) + header; no table.

Erasure interacts through the recovery policy: a dropped packet *was
transmitted* (its bytes and airtime are spent either way), and under
``"retransmit"`` it crosses the wire a second time next round, so its
bytes are counted twice. Under ``"rate_up"`` nothing is re-sent.

The time-on-air / energy model is deliberately simple (bytes / link rate,
times radio power): enough to rank transports and recovery policies, not
a radio simulation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.entropy_code import RansCodec

__all__ = ["WireModel", "measure_wire"]

_FREQ_BITS = 12   # rANS quantized-frequency width (entropy_code._SCALE_BITS)


@dataclasses.dataclass(frozen=True)
class WireModel:
    """Link parameters for the time-on-air / energy estimate."""

    bitrate_bps: float = 1e6      # link throughput
    tx_power_w: float = 0.1       # radio power while transmitting
    overhead_bytes: float = 8.0   # per-packet header (seq + length + crc)
    lossless_bits: float = 32.0   # wire width of an uncoded lossless round


def measure_wire(symbols, deltas, n_elem: int, drop=None,
                 recovery: str = "retransmit",
                 model: WireModel | None = None) -> dict:
    """rANS-code one request's symbol trace and account the wire bytes.

    ``symbols`` is the engine trace slice (T, P, L_pad) of quantizer
    indices (midtread, so integers around 0), ``deltas`` the (T,) realized
    bin sizes (non-finite = lossless round), ``n_elem`` the real payload
    length (N for row messages, M for column residual contributions —
    padding beyond it is sliced off).  ``drop`` is the (T, P) erasure mask
    actually applied (None = lossless link).

    Returns a dict with

      * ``payload_bytes``  — rANS payload only (the number comparable to
        the model entropy: ``H_Q * n_elem / 8`` per packet),
      * ``bytes_on_wire``  — payload + table + headers, with retransmitted
        packets double-counted under ``recovery="retransmit"``,
      * ``bytes_by_round`` — (T,) single-transmission bytes per round,
      * ``time_on_air_s``, ``energy_j`` — from the ``WireModel``.
    """
    model = model or WireModel()
    symbols = np.asarray(symbols)
    assert symbols.ndim == 3, symbols.shape
    t_n, p_n = symbols.shape[0], symbols.shape[1]
    assert n_elem <= symbols.shape[2], (n_elem, symbols.shape)
    pkt = np.zeros((t_n, p_n))          # full packet bytes, one transmission
    payload = np.zeros((t_n, p_n))      # rANS payload bytes only
    for t in range(t_n):
        if not np.isfinite(float(deltas[t])):
            raw = model.lossless_bits * n_elem / 8.0
            pkt[t, :] = raw + model.overhead_bytes
            payload[t, :] = raw
            continue
        for pi in range(p_n):
            stream = symbols[t, pi, :n_elem].astype(np.int64)
            shifted = stream - stream.min()
            counts = np.bincount(shifted)
            body = len(RansCodec(counts).encode(shifted))
            table = len(counts) * _FREQ_BITS / 8.0 + 4.0  # freqs + offset
            payload[t, pi] = body
            pkt[t, pi] = body + table + model.overhead_bytes
    total = float(pkt.sum())
    if drop is not None and recovery == "retransmit":
        # a dropped packet is re-sent next round: same bytes, twice on air
        d = np.asarray(drop, np.float64)[:t_n, :p_n]
        total += float((pkt * d).sum())
    time_s = total * 8.0 / model.bitrate_bps
    return {
        "payload_bytes": float(payload.sum()),
        "bytes_on_wire": total,
        "bytes_by_round": pkt.sum(axis=1),
        "time_on_air_s": time_s,
        "energy_j": time_s * model.tx_power_w,
    }
