"""Serving of the port: a dynamic-batching generation service that keeps
one fixed-batch sampler fed (``service.py``; on a card, one step replayed as
a CUDA graph), its builder from a config and a checkpoint (``builder.py``)
and a dependency-free HTTP front end (``server.py``); the twin of
``ldm_tpu/serving``.  ``python -m ldm_tpu_torch.serve CONFIG`` runs them.
"""

from ldm_tpu_torch.serving.server import GenerationHTTPServer
from ldm_tpu_torch.serving.service import GenerationService, ServiceStats

__all__ = ["GenerationService", "ServiceStats", "GenerationHTTPServer"]
