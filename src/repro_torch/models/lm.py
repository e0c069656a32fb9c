"""Decoder-only LM for serving (mirrors ``repro/models/lm.py``): the dense
families with global and sliding-window (local) attention, attention and
logit softcaps and a dense MLP, that is llama and gemma2.

Layers form a repeating *pattern* of block positions.  Parameters of each
pattern position are stacked over ``n_groups = n_layers / period`` exactly
as in the reference, which scans over that leading dim; the port loops over
it.  So the reference's parameter tree crosses over leaf for leaf
(``repro_torch.convert.lm_params_from_numpy``).  gemma2 alternates local
and global layers (period 2): even pattern positions are local, attending
the last ``sliding_window`` positions, as ``repro/models/lm.py:66`` builds
the pattern.

Two execution paths share the block code:
  * ``prefill``      plain forward that also emits the decode cache; its
                     attention goes through ``kernels.flash_attention``
                     (``models/layers.py::attention``);
  * ``decode_step``  one token per row against a cache, at per-row
                     positions, on one of two routes:
      - paged (``page_table`` given): the cache leaves are page pools
        ``(ng, num_pages, page_size, hkv, hd)``; each attention layer writes
        its new K/V row into the row's physical page and attends the pool
        through the page table (``kernels.flash_decode_paged``);
      - dense: the leaves are ``(ng, B, S, hkv, hd)`` caches; the new row is
        spliced at each row's position and attended with
        ``kernels.flash_decode``.

The reference's arrays are immutable; the port writes the new K/V rows into
the cache tensors *in place* (a copy of a full-width pool per step would
move gigabytes) and returns the same tensors.

Every attention layer passes its window (``sliding_window`` on local
layers, 0 on global ones) and ``attn_softcap`` to the prefill attention and
to both decode kernels; ``logit_softcap`` caps the head's logits.  Weights
and activations are float32, caches bfloat16 (the new K/V row is rounded to
nearest even on the write, as XLA rounds).  MoE, SSM, RWKV, the encoder and
the modality frontends raise ``NotImplementedError`` until their slices
arrive.  Training (the K-FAC-tagged forward and its loss) comes with the LM
training slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.models import params as PM
from repro_torch.models.head import head_logits
from repro_torch.models.layers import apply_rope, attention, dense, rms_norm
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class BlockSpec:
    pos: int
    attn: str            # global | local | mamba | rwkv
    mlp: str             # dense | moe | rwkv_cm
    cross: bool = False  # enc-dec decoder cross-attention


def build_pattern(cfg: ModelConfig) -> List[BlockSpec]:
    if cfg.attn_free:
        return [BlockSpec(0, "rwkv", "rwkv_cm")]
    period = 1
    if cfg.alt_local_global:
        period = 2
    if cfg.n_experts and cfg.moe_every > 1:
        period = math.lcm(period, cfg.moe_every)
    if cfg.attn_every > 1:
        period = math.lcm(period, cfg.attn_every)
    assert cfg.n_layers % period == 0, (cfg.name, cfg.n_layers, period)
    out = []
    for i in range(period):
        if cfg.attn_every > 1:
            attn = "global" if cfg.is_attn_layer(i) else "mamba"
        elif cfg.alt_local_global:
            attn = "local" if i % 2 == 0 else "global"
        else:
            attn = "global"
        mlp = "moe" if cfg.is_moe_layer(i) else "dense"
        out.append(BlockSpec(i, attn, mlp, cross=cfg.encoder_layers > 0))
    return out


def _check_ported(cfg: ModelConfig, pattern: List[BlockSpec]) -> None:
    missing = sorted({s.attn for s in pattern} - {"global", "local"}
                     | {s.mlp for s in pattern} - {"dense"})
    if cfg.encoder_layers or any(s.cross for s in pattern):
        missing.append("encoder/cross-attention")
    if cfg.frontend != "none":
        missing.append(f"{cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port's LM "
            f"runs global and local attention with a dense MLP)")


def _index(tree, g: int):
    """Group ``g`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


class LM:
    """The dense LM (llama, gemma2).  ``device`` defaults to ``"cuda"`` and
    raises without a card; pass ``"cpu"`` for the plain PyTorch versions."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pattern = build_pattern(cfg)
        _check_ported(cfg, self.pattern)
        self.period = len(self.pattern)
        self.n_groups = cfg.n_layers // self.period
        self.defs = self._param_defs()

    # ------------------------------------------------------------------
    # parameter definitions
    # ------------------------------------------------------------------
    def _block_defs(self, lead):
        cfg = self.cfg
        d, f, qd, kvd = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
        pd = lambda shape, **kw: PM.ParamDef(shape=tuple(lead) + shape, **kw)
        return {
            "ln1": pd((d,), init="zeros"),
            "attn": {"wq": pd((d, qd)), "wk": pd((d, kvd)),
                     "wv": pd((d, kvd)), "wo": pd((qd, d))},
            "ln2": pd((d,), init="zeros"),
            "mlp": {"wg": pd((d, f)), "wu": pd((d, f)), "wd": pd((f, d))},
        }

    def _param_defs(self):
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        defs: Dict[str, Any] = {
            "embed": PM.ParamDef((v, d), init="embed"),
            "final_ln": PM.ParamDef((d,), init="zeros"),
            "blocks": tuple(self._block_defs((self.n_groups,))
                            for _ in self.pattern),
        }
        if not cfg.tie_embeddings:
            defs["head"] = PM.ParamDef((d, v))
        return defs

    def init_params(self, generator: Optional[torch.Generator] = None):
        """The port's own float32 initial values (the reference's
        initializers and scales), drawn from ``generator`` (seed 0 on the
        model's device by default)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return PM.materialize(generator, self.defs, self.device)

    def n_params(self) -> int:
        return PM.count(self.defs)

    def head_weight(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    # ------------------------------------------------------------------
    # block application (shared by prefill / decode)
    # ------------------------------------------------------------------
    def _attn(self, p, x, positions, *, window, cache=None, decode_pos=None,
              build_cache=False, page_table=None):
        cfg = self.cfg
        cap = cfg.attn_softcap
        bsz, t, _ = x.shape
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = dense(p["wq"], x).reshape(bsz, t, hq, hd)
        k = dense(p["wk"], x).reshape(bsz, t, hkv, hd)
        v = dense(p["wv"], x).reshape(bsz, t, hkv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if cache is None:
            o = attention(q, k, v, causal=True, window=window, cap=cap)
            return (dense(p["wo"], o.reshape(bsz, t, hq * hd)),
                    {"k": k, "v": v} if build_cache else None)
        # decode, one token per row: write the row's new K/V (rounded to the
        # cache dtype) at its own position, then attend its valid keys
        assert t == 1, "decode is one token per row"
        new_k = k[:, 0].to(cache["k"].dtype)
        new_v = v[:, 0].to(cache["v"].dtype)
        if page_table is not None:
            # paged: page = table[b, pos // P], offset pos % P (idle rows
            # land on the allocator's null page); the kernel reads the table
            page_size = cache["k"].shape[1]
            slot = (decode_pos // page_size).long()[:, None]
            where = (torch.gather(page_table, 1, slot)[:, 0].long(),
                     (decode_pos % page_size).long())
            cache["k"][where], cache["v"][where] = new_k, new_v
            o = flash_decode_paged(q[:, 0], cache["k"], cache["v"],
                                   decode_pos + 1, page_table, window=window,
                                   cap=cap)
        else:
            # dense: the kernel reads the (B, S, Hkv, hd) cache through
            # strides, no transpose copy
            where = (torch.arange(bsz, device=x.device), decode_pos.long())
            cache["k"][where], cache["v"][where] = new_k, new_v
            o = flash_decode(q[:, 0], cache["k"].transpose(1, 2),
                             cache["v"].transpose(1, 2), decode_pos + 1,
                             window=window, cap=cap)
        return dense(p["wo"], o.reshape(bsz, t, hq * hd)), cache

    def _mlp(self, p, x):
        g = dense(p["wg"], x)
        u = dense(p["wu"], x)
        return dense(p["wd"], F.silu(g) * u)

    def _apply_block(self, spec, p, h, positions, cache=None, decode_pos=None,
                     build_cache=False, page_table=None):
        eps = self.cfg.norm_eps
        window = self.cfg.sliding_window if spec.attn == "local" else 0
        o, kvc = self._attn(p["attn"], rms_norm(h, p["ln1"], eps), positions,
                            window=window, cache=cache, decode_pos=decode_pos,
                            build_cache=build_cache, page_table=page_table)
        h = h + o
        h = h + self._mlp(p["mlp"], rms_norm(h, p["ln2"], eps))
        return h, kvc

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()]

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------
    def prefill(self, params, batch):
        """Full forward over ``batch["tokens"]`` (B, T); returns the
        last-token logits (B, 1, V) and the cache
        ``{"pos<i>": {"k", "v": (ng, B, T, hkv, hd)}}`` (float32, as the
        reference's compute dtype leaves it)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        h = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        per_group = {f"pos{i}": [] for i in range(self.period)}
        for g in range(self.n_groups):
            for i in range(self.period):
                h, c = self._apply_block(self.pattern[i],
                                         _index(params["blocks"][i], g), h,
                                         positions, build_cache=True)
                per_group[f"pos{i}"].append(c)
        cache = {name: {kv: torch.stack([c[kv] for c in cs])
                        for kv in ("k", "v")}
                 for name, cs in per_group.items()}
        h = rms_norm(h, params["final_ln"], cfg.norm_eps)
        logits = head_logits(h[:, -1:, :], self.head_weight(params),
                             cfg.logit_softcap)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos, page_table=None):
        """One decode step.  tokens: (B, 1); pos: an int, or a (B,) tensor
        of per-slot positions (each slot writes and attends at its own
        offset).  With ``page_table`` ((B, max_blocks) int32) the cache
        leaves are page pools shared by all rows, else dense per-row
        caches (see the module docstring).  Returns (logits (B, 1, V),
        cache); the cache tensors are updated in place."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        bsz = tokens.shape[0]
        pos_vec = torch.as_tensor(pos, dtype=torch.int32,
                                  device=self.device).reshape(-1)
        pos_vec = pos_vec.expand(bsz).contiguous()
        if page_table is not None:
            page_table = page_table.to(device=self.device, dtype=torch.int32)
        h = self._embed(params, tokens)
        positions = pos_vec[:, None]
        for g in range(self.n_groups):
            for i in range(self.period):
                h, _ = self._apply_block(
                    self.pattern[i], _index(params["blocks"][i], g), h,
                    positions,
                    cache=_index(cache[f"pos{i}"], g), decode_pos=pos_vec,
                    page_table=page_table)
        h = rms_norm(h, params["final_ln"], cfg.norm_eps)
        logits = head_logits(h, self.head_weight(params), cfg.logit_softcap)
        return logits, cache
