"""Serving: dynamic micro-batching and a standard-library HTTP front.

Concurrent requests are grouped into single `tts_batch` calls (synthesize.py:
padded static buckets, one host sync per batch), so one engine keeps the card
busy with batches instead of sequential batch-1 calls. The counterpart of the
JAX package's `serving/`.
"""

from zerovox_tpu_torch.serving.batcher import STREAM_EOS, BatcherStats, DynamicBatcher
from zerovox_tpu_torch.serving.server import VoiceRegistry, make_server, serve_in_thread

__all__ = ["STREAM_EOS", "BatcherStats", "DynamicBatcher", "VoiceRegistry", "make_server",
           "serve_in_thread"]
