"""Bytes serialization for the cluster frontend (the port of the JAX
package's ``repro.serving.codec``; its DESIGN.md §11 describes the format).
The frame format is the reference's byte for byte: a frame either package
encodes, the other decodes and re-encodes to the same bytes.

``SolveRequest``/``SolveResult`` cross host boundaries as bytes — never
pickle: the backend server decodes attacker-reachable payloads, and a
pickle there is remote code execution. The format is a fixed-magic,
versioned frame of

    b"AMP1" | u32 header_len | JSON header | raw array buffers

where the header carries every scalar field plus an ``arrays`` manifest
(name, dtype string, shape) and the buffers follow concatenated in
manifest order, C-contiguous little-endian. JSON covers all scalar field
types we ship (str/int/float/bool/None); arrays go raw, so the round
trip is bit-exact — including NaN/inf payloads and float rate columns —
which the property test pins.

Only fields of the public dataclasses are encoded: decode constructs
``SolveRequest``/``SolveResult``/``BucketKey``/``PrewarmSpec`` by
keyword, so unknown header keys (a newer peer) fail loudly instead of
smuggling state. Every malformed frame, a prior with an unknown or
missing key and a missing or unknown array included, raises
``CodecError`` and nothing else. A port ``SolveResult`` is numpy on the
host already (the service brings each result to the host once, when it is
finished), so encoding reads no device.
"""
from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

from ..core.denoisers import BernoulliGauss
from .buckets import BucketKey

__all__ = [
    "encode_request", "decode_request", "encode_result", "decode_result",
    "encode_metrics", "decode_metrics",
    "bucket_to_dict", "bucket_from_dict", "spec_to_dict", "spec_from_dict",
    "CodecError",
]

_MAGIC = b"AMP1"


class CodecError(ValueError):
    """Malformed or foreign frame (bad magic, truncated, unknown keys)."""


# -- framing ----------------------------------------------------------------

def _pack(header: dict, arrays: "dict[str, np.ndarray]") -> bytes:
    manifest = []
    bufs = []
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        if a.dtype.byteorder == ">":          # wire format is little-endian
            a = a.astype(a.dtype.newbyteorder("<"))
        manifest.append({"name": name, "dtype": a.dtype.str,
                         "shape": list(a.shape)})
        bufs.append(a.tobytes())
    header = dict(header, arrays=manifest)
    hj = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(hj)), hj] + bufs)


def _unpack(buf: bytes) -> "tuple[dict, dict[str, np.ndarray]]":
    if len(buf) < 8 or buf[:4] != _MAGIC:
        raise CodecError(f"bad frame magic {buf[:4]!r}")
    (hlen,) = struct.unpack("<I", buf[4:8])
    if len(buf) < 8 + hlen:
        raise CodecError("truncated header")
    try:
        header = json.loads(buf[8:8 + hlen])
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CodecError(f"bad header: {e}") from e
    if not isinstance(header, dict):
        raise CodecError(f"header is {type(header).__name__}, not object")
    manifest = header.pop("arrays", [])
    if not isinstance(manifest, list):
        raise CodecError("bad arrays manifest")
    arrays = {}
    off = 8 + hlen
    for ent in manifest:
        # a corrupted or hostile manifest must fail *here*, not as a
        # numpy crash (bad dtype string) or a giant allocation (negative
        # or overflowing dims) deeper in
        if not isinstance(ent, dict):
            raise CodecError("bad manifest entry")
        try:
            name, dts, shape = ent["name"], ent["dtype"], ent["shape"]
        except (KeyError, TypeError) as e:
            raise CodecError(f"bad manifest entry: {e}") from e
        if not (isinstance(shape, list)
                and all(isinstance(d, int) and 0 <= d < (1 << 40)
                        for d in shape)):
            raise CodecError(f"bad shape {shape!r} for array {name!r}")
        try:
            dt = np.dtype(dts)
        except (TypeError, ValueError) as e:
            raise CodecError(f"bad dtype {dts!r}: {e}") from e
        nb = dt.itemsize
        for d in shape:
            nb *= d
        if len(buf) < off + nb:
            raise CodecError(f"truncated array {name!r}")
        try:
            arrays[str(name)] = np.frombuffer(
                buf[off:off + nb], dt).reshape(tuple(shape)).copy()
        except ValueError as e:   # object/zero-width dtypes and kin
            raise CodecError(f"bad array {name!r}: {e}") from e
        off += nb
    if off != len(buf):
        raise CodecError(f"{len(buf) - off} trailing bytes")
    return header, arrays


def _take(header: dict, key: str):
    try:
        return header.pop(key)
    except KeyError:
        raise CodecError(f"missing header field {key!r}") from None


def _done(header: dict, kind: str) -> None:
    if header:
        raise CodecError(f"unknown {kind} fields {sorted(header)}")


# -- small pieces -----------------------------------------------------------

def _prior_to_dict(p: BernoulliGauss) -> dict:
    return {"eps": float(p.eps), "mu_s": float(p.mu_s),
            "sigma_s": float(p.sigma_s)}


_PRIOR_KEYS = ("eps", "mu_s", "sigma_s")


def _prior_from_dict(d) -> BernoulliGauss:
    """The prior's exact three keys, each a number: a renamed, missing or
    extra key is a ``CodecError``, never a ``TypeError`` out of the
    constructor."""
    if not isinstance(d, dict) or sorted(d) != sorted(_PRIOR_KEYS):
        raise CodecError(f"bad prior {d!r}: need the keys {_PRIOR_KEYS}")
    if not all(isinstance(d[k], (int, float)) and not isinstance(d[k], bool)
               for k in _PRIOR_KEYS):
        raise CodecError(f"bad prior {d!r}: the values must be numbers")
    return BernoulliGauss(**d)


def _array(arrays: dict, name: str) -> np.ndarray:
    try:
        return arrays.pop(name)
    except KeyError:
        raise CodecError(f"missing array {name!r}") from None


def bucket_to_dict(key: BucketKey) -> dict:
    return dataclasses.asdict(key)


def bucket_from_dict(d: dict) -> BucketKey:
    if not isinstance(d, dict):
        raise CodecError(f"bad bucket {d!r}")
    try:
        return BucketKey(**d)
    except TypeError as e:
        raise CodecError(f"bad bucket: {e}") from e


def spec_to_dict(spec) -> dict:
    """``PrewarmSpec`` as a JSON-able dict (remote-prewarm directives)."""
    d = dataclasses.asdict(spec)
    d["prior"] = _prior_to_dict(spec.prior)
    if d.get("batch_widths") is not None:
        d["batch_widths"] = list(d["batch_widths"])
    return d


def spec_from_dict(d: dict):
    from .service import PrewarmSpec
    if not isinstance(d, dict):
        raise CodecError(f"bad prewarm spec {d!r}")
    d = dict(d)
    d["prior"] = _prior_from_dict(_take(d, "prior"))
    if d.get("batch_widths") is not None:
        d["batch_widths"] = tuple(d["batch_widths"])
    try:
        return PrewarmSpec(**d)
    except TypeError as e:
        raise CodecError(f"bad prewarm spec: {e}") from e


# -- SolveRequest / SolveResult --------------------------------------------

def encode_request(req) -> bytes:
    header = {
        "kind": "request",
        "prior": _prior_to_dict(req.prior),
        "snr_db": req.snr_db, "n_proc": req.n_proc, "n_iter": req.n_iter,
        "policy": req.policy, "dp_total_bits": req.dp_total_bits,
        "bt_c_ratio": req.bt_c_ratio, "bt_r_max": req.bt_r_max,
        "transport": req.transport, "layout": req.layout,
        "erasure_rate": req.erasure_rate,
        "erasure_model": req.erasure_model,
        "erasure_burst": req.erasure_burst,
        "erasure_seed": req.erasure_seed,
        "recovery": req.recovery, "measure_wire": req.measure_wire,
        "a_id": req.a_id, "request_id": req.request_id,
        "spans": req.spans,
    }
    arrays = {"y": np.asarray(req.y), "a": np.asarray(req.a)}
    if req.deltas is not None:
        arrays["deltas"] = np.asarray(req.deltas)
    return _pack(header, arrays)


def decode_request(buf: bytes):
    from .service import SolveRequest
    header, arrays = _unpack(buf)
    if _take(header, "kind") != "request":
        raise CodecError("not a request frame")
    header["prior"] = _prior_from_dict(_take(header, "prior"))
    y, a = _array(arrays, "y"), _array(arrays, "a")
    deltas = arrays.pop("deltas", None)
    if arrays:
        raise CodecError(f"unknown request arrays {sorted(arrays)}")
    try:
        return SolveRequest(y=y, a=a, deltas=deltas, **header)
    except TypeError as e:   # unknown field from a newer peer: fail loudly
        raise CodecError(f"bad request: {e}") from e


def encode_result(res) -> bytes:
    header = {
        "kind": "result",
        "request_id": res.request_id,
        "total_bits": res.total_bits,
        "bucket": bucket_to_dict(res.bucket),
        "batch_size": res.batch_size,
        "bytes_on_wire": res.bytes_on_wire,
        "payload_bytes": res.payload_bytes,
        "time_on_air_s": res.time_on_air_s,
        "energy_j": res.energy_j,
        "se_drift": res.se_drift,
        "spans": res.spans,
    }
    arrays = {"x": np.asarray(res.x),
              "sigma2_hat": np.asarray(res.sigma2_hat),
              "deltas": np.asarray(res.deltas),
              "extra_var": np.asarray(res.extra_var),
              "rates": np.asarray(res.rates)}
    return _pack(header, arrays)


def decode_result(buf: bytes):
    from .service import SolveResult
    header, arrays = _unpack(buf)
    if _take(header, "kind") != "result":
        raise CodecError("not a result frame")
    header["bucket"] = bucket_from_dict(_take(header, "bucket"))
    try:
        return SolveResult(**header, **arrays)
    except TypeError as e:
        raise CodecError(f"bad result: {e}") from e


# -- telemetry metrics frames ----------------------------------------------

def encode_metrics(host, snapshot: dict) -> bytes:
    """Metrics registry snapshot as a codec frame (DESIGN.md §12): pure
    JSON header, no array segments — snapshots are small and already
    plain data, and reusing the frame keeps the no-pickle invariant."""
    return _pack({"kind": "metrics", "host": str(host),
                  "metrics": snapshot}, {})


def decode_metrics(buf: bytes) -> "tuple[str, dict]":
    header, arrays = _unpack(buf)
    if _take(header, "kind") != "metrics":
        raise CodecError("not a metrics frame")
    if arrays:
        raise CodecError(f"unexpected arrays {sorted(arrays)}")
    host = _take(header, "host")
    snap = _take(header, "metrics")
    if not isinstance(snap, dict) or not isinstance(snap.get("metrics"), list):
        raise CodecError("bad metrics payload")
    _done(header, "metrics")
    return host, snap
