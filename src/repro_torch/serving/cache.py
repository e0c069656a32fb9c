"""Paged KV cache: page pools per layer group + gather/scatter views
(mirrors ``repro/serving/cache.py``).

Layout
------
For every attention pattern position ``posX`` of the model there is one
``k`` and one ``v`` pool of shape ``(ng, num_pages, page_size, hkv, hd)``
in bfloat16 (``ng`` = the model's group count).  All layers share one
page-id space: a slot's page-table row lists the physical pages backing
its logical positions in order, and that row indexes every layer's pools —
the vLLM-style block table.

The default decode route is paged: ``LM.decode_step`` takes the pools and
the ``(B, max_blocks)`` page table to ``kernels.flash_decode_paged``, which
reads the table in the kernel.  ``gather`` + ``scatter_token`` are the
oracle route (``Engine(decode_route="gather")``): pages gathered into a
dense ``(ng, B, S_view, hkv, hd)`` cache (``S_view = max_blocks *
page_size``), decode against it with ``kernels.flash_decode``, and the one
new row scattered back.  Idle rows carry a page table of null pages (page
0, reserved by the allocator), so their writes never touch a live
allocation, and every row attends only its own ``[0, len_b)`` prefix, all
of which its current owner wrote: a recycled page is fully overwritten
before any of it is attended.

The reference updates its pools functionally; the port writes them in
place (``scatter_token``, ``write_prefill``, and the paged decode itself).
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _check_supported(model) -> None:
    """The engine serves attention decoders with global and local
    (sliding-window) layers, as the reference's does.  A local layer keeps
    every page of its row, inside the window or not (the reference frees
    none either); its kernels attend only the window."""
    cfg = model.cfg
    kinds = sorted({s.attn for s in model.pattern})
    if (not set(kinds) <= {"global", "local"} or cfg.encoder_layers
            or any(s.cross for s in model.pattern)):
        raise NotImplementedError(
            f"paged serving engine supports global/local-attention decoders; "
            f"{cfg.name} has attn kinds {kinds}"
            + (", encoder/cross-attention" if cfg.encoder_layers else ""))


class PagedKVCache:
    """Owns the pool layout and the gather/scatter/prefill-write functions.
    The pools themselves are a plain dict held by the engine."""

    def __init__(self, model, *, batch_slots: int, max_len: int,
                 page_size: int = 8, num_pages: int = None,
                 dtype=torch.bfloat16):
        _check_supported(model)
        if page_size < 1:
            raise ValueError(f"page_size={page_size}")
        self.model = model
        self.b = batch_slots
        self.max_len = max_len
        self.page_size = page_size
        self.max_blocks = max(1, math.ceil(max_len / page_size))
        self.s_view = self.max_blocks * page_size
        # default capacity: every slot can reach max_len, + 1 null page
        self.num_pages = (1 + batch_slots * self.max_blocks
                          if num_pages is None else num_pages)
        self.dtype = dtype
        cfg = model.cfg
        self.layer_names = [f"pos{i}" for i in range(len(model.pattern))]
        self._kv_shape = (model.n_groups, self.num_pages, page_size,
                          cfg.n_kv_heads, cfg.hd)

    def blocks_for(self, n_positions: int) -> int:
        """Pages needed to back ``n_positions`` logical cache entries."""
        return max(1, math.ceil(n_positions / self.page_size))

    # -- pool construction -------------------------------------------------
    def init_pools(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Zeroed pools on the model's device."""
        dev = self.model.device
        return {name: {"k": torch.zeros(self._kv_shape, dtype=self.dtype,
                                        device=dev),
                       "v": torch.zeros(self._kv_shape, dtype=self.dtype,
                                        device=dev)}
                for name in self.layer_names}

    # -- views ---------------------------------------------------------------
    def gather(self, pools, page_table):
        """pools + ``(B, max_blocks)`` page table -> dense decode cache
        ``{posX: {k,v: (ng, B, S_view, hkv, hd)}}`` in logical order (a
        copy)."""
        ng = self.model.n_groups
        idx = page_table.long()

        def one(pool):
            g = pool[:, idx]                       # (ng, B, nb, P, hkv, hd)
            return g.reshape(ng, self.b, self.s_view, *pool.shape[3:])

        return {name: {"k": one(p["k"]), "v": one(p["v"])}
                for name, p in pools.items()}

    def scatter_token(self, pools, dense_cache, page_table, pos):
        """Write each row's K/V at logical position ``pos[b]`` (just
        spliced into the dense view by ``decode_step``) back to its
        physical page, in place."""
        pos = pos.long()
        bidx = torch.arange(self.b, device=pos.device)
        page = torch.gather(page_table.long(), 1,
                            (pos // self.page_size)[:, None])[:, 0]
        off = pos % self.page_size
        for name, p in pools.items():
            for kv in ("k", "v"):
                row = dense_cache[name][kv][:, bidx, pos]  # (ng,B,hkv,hd)
                p[kv][:, page, off] = row.to(p[kv].dtype)
        return pools

    # -- prefill write -----------------------------------------------------
    def write_prefill(self, pools, pages, prefill_cache, prompt_len: int,
                      row: int = 0):
        """Write row ``row`` of a (possibly multi-request) prefill cache
        (``(ng, B, Tp, hkv, hd)`` leaves) into the first
        ``blocks_for(prompt_len)`` of ``pages``, rounding to the pool's
        dtype, in place."""
        nb = self.blocks_for(prompt_len)
        if nb > len(pages):
            raise ValueError(f"prompt needs {nb} pages, slot holds "
                             f"{len(pages)}")
        pids = torch.as_tensor(pages[:nb], dtype=torch.long,
                               device=self.model.device)
        ng = self.model.n_groups
        for name in self.layer_names:
            for kv in ("k", "v"):
                pool = pools[name][kv]
                x = prefill_cache[name][kv][:, row, :prompt_len]
                buf = torch.zeros((ng, nb * self.page_size) + x.shape[2:],
                                  dtype=pool.dtype, device=pool.device)
                buf[:, :prompt_len] = x
                pool[:, pids] = buf.reshape(ng, nb, self.page_size,
                                            *x.shape[2:])
        return pools
