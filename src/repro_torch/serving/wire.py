"""Bytes on the wire: measured rANS accounting and the TCP frame transport
(the JAX package's ``repro.serving.wire``, kept as it is; its DESIGN.md
§10 and §13).

Two layers share this module because they share one concern, what
actually crosses a link:

  * **Measured wire-byte accounting** (below): the paper's rate numbers
    are model entropies H_Q, "achievable through entropy coding". When a
    request opts in (``SolveRequest.measure_wire``), each round's
    per-processor quantizer symbol stream from the engine trace is
    actually rANS-coded (``core.entropy_code.RansCodec``, static
    per-stream model) on the host and the *measured* byte count is
    reported next to the model rate.
  * **TCP frame transport** (bottom half): the length-prefixed frame
    protocol ``TcpBackend`` / ``BackendServer`` speak, hardened for the
    fault model: bounded frame sizes, every read bounded by the socket's
    timeout through ``recv_exact``, and typed error frames that carry the
    remote traceback and a per-request vs backend-fatal flag, so the
    router can tell a bad request from a dying host.

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
import json
import struct
import traceback as _traceback

import numpy as np

from ..core.entropy_code import RansCodec
from .codec import CodecError

__all__ = ["WireModel", "measure_wire",
           "FrameError", "BackendError", "BackendUnavailable",
           "RemoteRequestError", "MAX_FRAME_BYTES",
           "recv_exact", "send_frame", "recv_frame",
           "pack_error", "remote_error"]

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


# Frame: u32 length | 1-byte op | body. Replies: u32 length | 1-byte
# status (b"R" ok / b"E" error) | body. Error bodies are JSON
# ``{type, msg, traceback, fatal}`` (``pack_error``); ``fatal`` marks
# backend-level failures where the server closes the connection —
# everything else is a per-request error the connection survives.

# A solve frame is one request's (M, N) float32 operand plus headers:
# far under a GiB for any real bucket. Anything bigger is a desynced or
# hostile stream, and rejecting it *before* the allocate-and-recv loop is
# what keeps a corrupt length prefix from looking like a hung peer.
MAX_FRAME_BYTES = 1 << 30


class FrameError(CodecError):
    """Malformed frame at the transport layer (bad length, empty frame,
    truncated nesting). The stream is desynced: the connection cannot be
    trusted afterwards — callers must drop it, not resync."""


class BackendError(RuntimeError):
    """Base of the typed backend failure hierarchy the router consumes."""


class BackendUnavailable(BackendError):
    """Connection-level failure: refused, reset, timed out, or a desynced
    stream. Signals a *dying host* — counts toward the suspect/dead
    threshold and triggers failover of in-flight requests."""


class RemoteRequestError(BackendError):
    """The backend rejected or failed *this request* but the connection
    (and the host) survive. Carries the remote traceback so the failure
    is debuggable from the frontend. Does NOT count toward host death."""

    def __init__(self, host_id: str, remote_type: str, msg: str,
                 remote_traceback: str = ""):
        self.host_id = host_id
        self.remote_type = remote_type
        self.remote_traceback = remote_traceback
        detail = f"\n--- remote traceback ---\n{remote_traceback}" \
            if remote_traceback else ""
        super().__init__(f"backend {host_id}: {remote_type}: {msg}{detail}")


def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes. Honors the socket's configured timeout
    (``TimeoutError`` propagates — a half-dead peer must not hang the
    caller forever) and refuses a socket without one; raises
    ``ConnectionError`` on mid-frame close."""
    if sock.gettimeout() is None:
        raise ValueError("recv_exact: the socket has no timeout; every "
                         "read must be bounded")
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock, op: bytes, body: bytes = b"") -> None:
    sock.sendall(struct.pack("<I", len(body) + 1) + op + body)


def recv_frame(sock) -> "tuple[bytes, bytes]":
    (ln,) = struct.unpack("<I", recv_exact(sock, 4))
    if ln < 1:
        raise FrameError("empty frame (no opcode)")
    if ln > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {ln} exceeds {MAX_FRAME_BYTES}")
    payload = recv_exact(sock, ln)
    return payload[:1], payload[1:]


def pack_error(exc: BaseException, fatal: bool) -> bytes:
    """Typed error-frame body: exception type + message + the full remote
    traceback, plus whether the backend considers itself dying."""
    return json.dumps({
        "type": type(exc).__name__,
        "msg": str(exc),
        "traceback": _traceback.format_exc(),
        "fatal": bool(fatal),
    }, separators=(",", ":")).encode()


def remote_error(host_id: str, body: bytes) -> BackendError:
    """Rebuild the typed exception from an error-frame body. Fatal errors
    (the server is closing the connection) surface as
    ``BackendUnavailable``; everything else is a ``RemoteRequestError``
    carrying the remote traceback."""
    try:
        d = json.loads(body)
        rtype, msg = str(d["type"]), str(d["msg"])
        tb, fatal = str(d.get("traceback", "")), bool(d.get("fatal"))
    except (ValueError, KeyError, TypeError):
        # pre-typed-frame peer (or garbage): treat as per-request
        return RemoteRequestError(host_id, "RemoteError",
                                  body.decode(errors="replace"))
    if fatal:
        return BackendUnavailable(
            f"backend {host_id} fatal {rtype}: {msg}\n"
            f"--- remote traceback ---\n{tb}")
    return RemoteRequestError(host_id, rtype, msg, tb)
