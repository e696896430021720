"""Serving front for the port's AMP engine on one device (the single-host
part of the JAX package's ``repro.serving``): heterogeneous CS solve
requests -> shape buckets -> batched engine calls (``solve_het``) ->
per-request results with realized-rate accounting, on a device-resident
operand cache, with the telemetry plane (``repro_torch.telemetry``)
threaded through. The cluster tier and the device mesh are not ported yet
(ROADMAP.md Queue 1 items 6 and 7).
"""
from .batcher import Batcher
from .buckets import (BucketKey, BucketPolicy, batch_width_ladder,
                      bucket_for, pad_batch_size, placement_for)
from .operand_cache import OperandCache, fingerprint
from .service import PrewarmSpec, SolveRequest, SolveResult, SolveService
from .wire import WireModel, measure_wire

__all__ = [
    "Batcher", "BucketKey", "BucketPolicy", "batch_width_ladder",
    "bucket_for", "pad_batch_size", "placement_for", "OperandCache",
    "fingerprint", "PrewarmSpec", "SolveRequest", "SolveResult",
    "SolveService", "WireModel", "measure_wire",
]
