"""Batched verdict engine: request encoding, the verdict and action-lane
functions, and the Python plane's batching service."""

from .batch import (RequestBatch, RequestTuple, batch_to_contexts,
                    encode_requests, pad_batch)
from .verdict import (action_lanes, evaluate_batch, first_action,
                      make_lane_fn, make_verdict_fn)

__all__ = [
    "RequestBatch", "RequestTuple", "action_lanes", "batch_to_contexts",
    "encode_requests", "evaluate_batch", "first_action", "make_lane_fn",
    "make_verdict_fn", "pad_batch",
]
