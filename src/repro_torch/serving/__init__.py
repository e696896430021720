"""Serving front for the port's AMP engine (the port of the JAX package's
``repro.serving``): heterogeneous CS solve requests -> shape buckets ->
batched engine calls (``solve_het``) -> per-request results with
realized-rate accounting, on a device-resident operand cache, with the
telemetry plane (``repro_torch.telemetry``) threaded through. The cluster
tier splits into a frontend (``ClusterService`` admission + host
backends), a scheduler (``ClusterRouter`` + ``Autoscaler``) and
per-host ``SolveService`` backends, with ``serving.codec`` bytes on the
wire between hosts, and the fault-tolerance plane (health probes walking
hosts through healthy/suspect/dead, bit-identical failover replay, tail
hedging, the shed ladder and the seeded chaos harness ``serving.chaos``).
On a device mesh (``SolveService(mesh=...)``, rank 0 of a
``torch.distributed`` world; ``serve_mesh_worker`` on the others) buckets
are placed data-parallel or processor-sharded (``placement_for``).
"""
from .batcher import Batcher
from .buckets import (BucketKey, BucketPolicy, batch_width_ladder,
                      bucket_for, pad_batch_size, placement_for)
from .chaos import ChaosBackend, ChaosProxy, FaultPlan, FaultSpec
from .codec import (CodecError, decode_metrics, decode_request,
                    decode_result, encode_metrics, encode_request,
                    encode_result)
from .frontend import (BackendServer, ClusterService, LocalBackend,
                       ShedLadder, TcpBackend)
from .operand_cache import OperandCache, fingerprint
from .router import (Autoscaler, ClusterRouter, DemandTracker, HostInfo,
                     Overloaded, RouterPolicy, routing_key, shape_cost)
from .service import (PrewarmSpec, SolveRequest, SolveResult, SolveService,
                      serve_mesh_worker)
from .wire import (BackendError, BackendUnavailable, FrameError,
                   RemoteRequestError, WireModel, measure_wire)

__all__ = [
    "Batcher", "BucketKey", "BucketPolicy", "batch_width_ladder",
    "bucket_for", "pad_batch_size", "placement_for", "OperandCache",
    "fingerprint", "PrewarmSpec", "SolveRequest", "SolveResult",
    "SolveService", "serve_mesh_worker", "WireModel", "measure_wire",
    # cluster tier
    "ClusterService", "LocalBackend", "BackendServer", "TcpBackend",
    "ClusterRouter", "Autoscaler", "DemandTracker", "HostInfo",
    "RouterPolicy", "Overloaded", "routing_key", "shape_cost",
    "encode_request", "decode_request", "encode_result", "decode_result",
    "encode_metrics", "decode_metrics", "CodecError",
    # fault-tolerance plane
    "BackendError", "BackendUnavailable", "RemoteRequestError",
    "FrameError", "ShedLadder", "FaultSpec", "FaultPlan", "ChaosBackend",
    "ChaosProxy",
]
