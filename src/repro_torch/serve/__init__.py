"""Continuous-batching inference (mirrors ``repro.serve``): the slot
engine and its admission queue.  The reference's weight hot-swap hook into
``FedEngine`` (``serve/swap.py``) and load generator (``serve/loadgen.py``)
come with a later slice."""
from .engine import DEFAULT_BUCKETS, ServeEngine
from .queue import AdmissionQueue, Request, Response, bucket_of

__all__ = ["AdmissionQueue", "DEFAULT_BUCKETS", "Request", "Response",
           "ServeEngine", "bucket_of"]
