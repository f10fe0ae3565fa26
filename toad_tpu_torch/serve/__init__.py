"""Online serving: dynamic-batching inference on one device behind a JSON
HTTP API. See :mod:`.batcher` for the batching discipline and :mod:`.server`
for the HTTP surface."""

from toad_tpu_torch.serve.batcher import BatcherStats, DynamicBatcher, ServeConfig
from toad_tpu_torch.serve.server import InferenceService, make_http_server, serve_in_thread

__all__ = [
    "BatcherStats",
    "DynamicBatcher",
    "ServeConfig",
    "InferenceService",
    "make_http_server",
    "serve_in_thread",
]
