"""Continuous-batching inference with live weight hot-swap from the
federated trainer (mirrors ``repro.serve``): the slot engine, its admission
queue, the load generator and the hot-swap hook into ``FedEngine``.  The
reference's ``jit_cache_size`` has no counterpart: the port compiles no
programs."""
from .engine import DEFAULT_BUCKETS, ServeEngine
from .loadgen import LoadSpec, draw_arrivals, run_load, summarize
from .queue import AdmissionQueue, Request, Response, bucket_of
from .swap import WeightSync, attach, swap_from_checkpoint

__all__ = ["AdmissionQueue", "DEFAULT_BUCKETS", "LoadSpec", "Request",
           "Response", "ServeEngine", "WeightSync", "attach", "bucket_of",
           "draw_arrivals", "run_load", "summarize", "swap_from_checkpoint"]
