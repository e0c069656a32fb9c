"""Façade of the serving package (mirrors ``repro/serving/server.py``):
the stable entry points, the submodules hold the pieces.

* :class:`Engine` / :func:`serial_engine` / :class:`RunReport` — engine
* :class:`Request` — request dataclass (queue states in ``scheduler``;
  sampling params ``temperature``/``top_k``/``top_p``/``seed`` ride on it)
* :class:`PageAllocator` / :class:`PagedKVCache` — cache machinery
* :func:`sample_token` / :func:`filter_logits` — the sampling layer
"""
from repro_torch.serving.allocator import NULL_PAGE, PageAllocator
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import (DECODE_ROUTES, Engine, RunReport,
                                        serial_engine)
from repro_torch.serving.sampling import filter_logits, sample_token
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["Engine", "RunReport", "Request", "Scheduler", "PageAllocator",
           "PagedKVCache", "serial_engine", "NULL_PAGE", "DECODE_ROUTES",
           "sample_token", "filter_logits"]
