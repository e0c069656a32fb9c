"""The LM (mirrors ``repro/models/lm.py``): the dense decoder families with
global and sliding-window (local) attention, attention and logit softcaps
and a dense MLP (llama, gemma2), served and trained; and the
encoder-decoder whisper with its Conv1D mel stem, trained.  gemma2's d_ff
of 9216 is above ``KFACConfig.max_factor_dim`` (8192), so the d_ff sides
of its MLP take block-diagonal factors (two blocks of 4608;
``core/blocks/kron.py::BlockDiagKronecker``).

Layers form a repeating *pattern* of block positions.  Parameters of each
pattern position are stacked over ``n_groups = n_layers / period`` exactly
as in the reference, which scans over that leading dim; the port loops over
it.  So the reference's parameter tree crosses over leaf for leaf
(``repro_torch.convert.lm_params_from_numpy``).  gemma2 alternates local
and global layers (period 2): even pattern positions are local, attending
the last ``sliding_window`` positions, as ``repro/models/lm.py:66`` builds
the pattern.

Training and serving run separate block code, so that serving does no
K-FAC work:
  * ``loss`` / ``hidden``  the training forward, K-FAC tagged
                     (``core/tags.py``; ``models/layers.py::tagged_dense``):
                     plain mode for the gradient pass, collect mode (zero
                     probes, recorded inputs) for the statistics pass.  Its
                     attention is the reference's differentiable chunked
                     function (``models/layers.py::attention_train``).
                     Stacked layers take group ``g`` of the parameters and
                     probes as ``unbind`` views, so gradients come back
                     stacked, and their records are stacked per group.
                     whisper (``family="audio"``): the Conv1D stem (k 3 s 1,
                     then k 3 s 2, tanh-approximate GELU after each, as
                     ``jax.nn.gelu`` defaults) on the raw mels, KFC-tagged
                     (``models/conv.py``), a full-attention encoder, and
                     decoder blocks with cross-attention; no RoPE, a
                     sinusoidal position embedding on both sides.
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
nearest even on the write, as XLA rounds).  MoE, SSM, RWKV and the vision
frontend raise ``NotImplementedError`` until their slices arrive.  Serving
whisper (its cross-attention cache) is not ported yet: the serving engine
refuses an encoder-decoder when it builds its pools
(``serving/cache.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import KFACConfig, ModelConfig
from repro_torch.core.factors import factor_layout
from repro_torch.core.tags import LayerMeta, Tagger, merge_records
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.models import params as PM
from repro_torch.models.conv import conv, conv_meta, conv_out_len
from repro_torch.models.head import head_logits, lm_head_loss
from repro_torch.models.layers import (apply_rope, attention,
                                       attention_train, dense, rms_norm,
                                       tagged_dense)
from repro_torch.utils.device import resolve_device

_PLAIN = Tagger("plain")


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
    if cfg.frontend not in ("none", "audio"):
        missing.append(f"{cfg.frontend} frontend")
    if bool(cfg.encoder_layers) != (cfg.frontend == "audio"):
        # the reference runs its encoder only behind the audio stem
        missing.append("an encoder without the audio frontend (or the "
                       "reverse)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port's LM "
            f"runs global and local attention with a dense MLP, and "
            f"whisper's encoder)")


_TAG_LEAVES = {"attn": ("q", "k", "v", "o"), "cross": ("q", "k", "v", "o"),
               "mlp": ("gate", "up", "down")}


def _tag_names(prefix: str) -> Dict[str, Dict[str, str]]:
    """The K-FAC names of a block's dense maps, ``{part: {leaf:
    "prefix.part.leaf"}}``."""
    return {part: {w: f"{prefix}.{part}.{w}" for w in leaves}
            for part, leaves in _TAG_LEAVES.items()}


def sinusoid_posemb(t: int, d: int, device=None):
    """(t, d) sinusoidal position embedding: [sin(pos·f), cos(pos·f)]."""
    pos = torch.arange(t, dtype=torch.float32, device=device)
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=device) / half)
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _groups(tree, n: int):
    """The n groups of a stacked parameter tree as ``unbind`` views (their
    gradients and tangents come back stacked)."""
    if isinstance(tree, dict):
        parts = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _stack_records(recs):
    """Per-group records ``[{name: {"a": x}}, ...]`` -> ``{name: {"a":
    stacked}}``."""
    if not recs or not recs[0]:
        return {}
    return {name: {k: torch.stack([r[name][k] for r in recs])
                   for k in recs[0][name]}
            for name in recs[0]}


def _index(tree, g: int):
    """Group ``g`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


class LM:
    """The LM (llama, gemma2, whisper).  ``kfac`` (default
    ``KFACConfig()``) gives the metas' factor layouts through its
    ``max_factor_dim``, as the reference's ``LM(cfg, kfac, mesh)``.
    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``"cpu"`` for the plain PyTorch versions."""

    def __init__(self, cfg: ModelConfig, kfac: Optional[KFACConfig] = None,
                 device="cuda"):
        self.cfg = cfg
        self.kfac = kfac or KFACConfig()
        self.device = resolve_device(device)
        self.pattern = build_pattern(cfg)
        _check_ported(cfg, self.pattern)
        self.period = len(self.pattern)
        self.n_groups = cfg.n_layers // self.period
        self.tag_names = [_tag_names(f"blk{i}") for i in range(self.period)]
        self.enc_tag_names = _tag_names("enc")
        self.defs = self._param_defs()
        self.metas = self._layer_metas()
        # fused_stats hooks (core/fused.py): empty, and filled by a K-FAC
        # engine for its statistics pass alone (whisper's conv stems are
        # the only eligible layers)
        self.contract_map: Dict[str, Any] = {}
        self.gcontract_map: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # parameter definitions
    # ------------------------------------------------------------------
    def _attn_defs(self, pd):
        d, qd, kvd = self.cfg.d_model, self.cfg.q_dim, self.cfg.kv_dim
        return {"wq": pd((d, qd)), "wk": pd((d, kvd)), "wv": pd((d, kvd)),
                "wo": pd((qd, d))}

    def _block_defs(self, lead, cross=False):
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        pd = lambda shape, **kw: PM.ParamDef(shape=tuple(lead) + shape, **kw)
        p = {"ln1": pd((d,), init="zeros"), "attn": self._attn_defs(pd)}
        if cross:
            p["ln_cross"] = pd((d,), init="zeros")
            p["cross"] = self._attn_defs(pd)
        p["ln2"] = pd((d,), init="zeros")
        p["mlp"] = {"wg": pd((d, f)), "wu": pd((d, f)), "wd": pd((f, d))}
        return p

    def _param_defs(self):
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        defs: Dict[str, Any] = {
            "embed": PM.ParamDef((v, d), init="embed"),
            "final_ln": PM.ParamDef((d,), init="zeros"),
            "blocks": tuple(self._block_defs((self.n_groups,), s.cross)
                            for s in self.pattern),
        }
        if not cfg.tie_embeddings:
            defs["head"] = PM.ParamDef((d, v))
        if cfg.encoder_layers:
            defs["enc_blocks"] = self._block_defs((cfg.encoder_layers,))
            defs["enc_final_ln"] = PM.ParamDef((d,), init="zeros")
        if cfg.frontend == "audio":
            # whisper's Conv1D stem: mels -> d (k 3 s 1), d -> d (k 3 s 2);
            # tap-major patch matrices, the bias as the last row
            defs["enc_conv1"] = PM.ParamDef((3 * cfg.n_mels + 1, d))
            defs["enc_conv2"] = PM.ParamDef((3 * d + 1, d))
        return defs

    def init_params(self, generator: Optional[torch.Generator] = None):
        """The port's own float32 initial values (the reference's
        initializers and scales, the conv stems' bias rows zeroed), drawn
        from ``generator`` (seed 0 on the model's device by default)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = PM.materialize(generator, self.defs, self.device)
        for name in ("enc_conv1", "enc_conv2"):
            if name in params:
                params[name][-1].zero_()
        return params

    def n_params(self) -> int:
        return PM.count(self.defs)

    def head_weight(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    # ------------------------------------------------------------------
    # K-FAC layer metadata
    # ------------------------------------------------------------------
    def _layer_metas(self) -> Dict[str, LayerMeta]:
        cfg = self.cfg
        mfd = self.kfac.max_factor_dim
        metas: Dict[str, LayerMeta] = {}

        def add(name, path, n_stack, probe_tshard=False):
            pdef = self.defs
            for k in path:
                pdef = pdef[k]
            d_in, d_out = pdef.shape[-2:]
            # no tensor-parallel mesh yet: sharded=False, tp=1
            a_kind, a_blocks = factor_layout(d_in, False, 1, mfd)
            g_kind, g_blocks = factor_layout(d_out, False, 1, mfd)
            metas[name] = LayerMeta(name=name, param_path=path, d_in=d_in,
                                    d_out=d_out, kind="dense",
                                    n_stack=n_stack, a_kind=a_kind,
                                    g_kind=g_kind, a_blocks=a_blocks,
                                    g_blocks=g_blocks,
                                    probe_tshard=probe_tshard)

        weight = {"q": "wq", "k": "wk", "v": "wv", "o": "wo", "gate": "wg",
                  "up": "wu", "down": "wd"}

        def add_block(names, path, parts, n_stack):
            for part in parts:
                for w, name in names[part].items():
                    # the reference's flag for the decoder's self-attention
                    # q/k/v (its context-parallel probes); the port reads
                    # it nowhere, but a bundle's metas carry it
                    add(name, path + (part, weight[w]), n_stack,
                        probe_tshard=(path[0] == "blocks" and part == "attn"
                                      and w in ("q", "k", "v")))

        for pos, spec in enumerate(self.pattern):
            add_block(self.tag_names[pos], ("blocks", pos),
                      ("attn", "cross", "mlp") if spec.cross
                      else ("attn", "mlp"), self.n_groups)
        if cfg.encoder_layers:
            add_block(self.enc_tag_names, ("enc_blocks",), ("attn", "mlp"),
                      cfg.encoder_layers)
        if cfg.frontend == "audio":
            metas["enc.conv1"] = conv_meta(
                "enc.conv1", ("enc_conv1",), spatial=(3,), stride=(1,),
                c_in=cfg.n_mels, d_out=cfg.d_model, padding="SAME",
                max_factor_dim=mfd)
            metas["enc.conv2"] = conv_meta(
                "enc.conv2", ("enc_conv2",), spatial=(3,), stride=(2,),
                c_in=cfg.d_model, d_out=cfg.d_model, padding="SAME",
                max_factor_dim=mfd)
        # embedding: diagonal A (token frequencies), full G on d_model
        metas["embed"] = LayerMeta(
            name="embed", param_path=("embed",), d_in=cfg.vocab_size,
            d_out=cfg.d_model, kind="embed", a_kind="diag", g_kind="full")
        if not cfg.tie_embeddings:
            metas["lm_head"] = LayerMeta(
                name="lm_head", param_path=("head",), d_in=cfg.d_model,
                d_out=cfg.vocab_size, kind="head", a_kind="full",
                g_kind="diag")
        return metas

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
    # training blocks (K-FAC tagged; the serving blocks above are untagged)
    # ------------------------------------------------------------------
    def _attn_train(self, tg, names, p, x, positions, *, window,
                    causal=True):
        cfg = self.cfg
        bsz, t, _ = x.shape
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = tagged_dense(tg, names["q"], p["wq"], x).reshape(bsz, t, hq, hd)
        k = tagged_dense(tg, names["k"], p["wk"], x).reshape(bsz, t, hkv, hd)
        v = tagged_dense(tg, names["v"], p["wv"], x).reshape(bsz, t, hkv, hd)
        if cfg.family != "audio":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        o = attention_train(q, k, v, causal=causal, window=window,
                            cap=cfg.attn_softcap)
        return tagged_dense(tg, names["o"], p["wo"],
                            o.reshape(bsz, t, hq * hd))

    def _cross_attn(self, tg, names, p, x, enc_out):
        """Decoder cross-attention over the encoder output."""
        cfg = self.cfg
        bsz, t, _ = x.shape
        tk = enc_out.shape[1]
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = tagged_dense(tg, names["q"], p["wq"], x).reshape(bsz, t, hq, hd)
        k = tagged_dense(tg, names["k"], p["wk"], enc_out).reshape(
            bsz, tk, hkv, hd)
        v = tagged_dense(tg, names["v"], p["wv"], enc_out).reshape(
            bsz, tk, hkv, hd)
        o = attention_train(q, k, v, causal=False)
        return tagged_dense(tg, names["o"], p["wo"],
                            o.reshape(bsz, t, hq * hd))

    def _mlp_train(self, tg, names, p, x):
        g = tagged_dense(tg, names["gate"], p["wg"], x)
        u = tagged_dense(tg, names["up"], p["wu"], x)
        return tagged_dense(tg, names["down"], p["wd"], F.silu(g) * u)

    def _block_train(self, spec, tg, p, h, positions, enc_out):
        eps = self.cfg.norm_eps
        names = self.tag_names[spec.pos]
        window = self.cfg.sliding_window if spec.attn == "local" else 0
        h = h + self._attn_train(tg, names["attn"], p["attn"],
                                 rms_norm(h, p["ln1"], eps), positions,
                                 window=window)
        if spec.cross:
            h = h + self._cross_attn(tg, names["cross"], p["cross"],
                                     rms_norm(h, p["ln_cross"], eps),
                                     enc_out)
        return h + self._mlp_train(tg, names["mlp"], p["mlp"],
                                   rms_norm(h, p["ln2"], eps))

    @staticmethod
    def _group_probes(probes, prefix, n):
        """Group g's probes of the stacked layers named ``prefix*``."""
        parts = {k: v.unbind(0) for k, v in (probes or {}).items()
                 if k.startswith(prefix) and ".conv" not in k}
        return [{k: v[g] for k, v in parts.items()} for g in range(n)]

    def _encoder(self, params, mels, tg, mode, probes):
        """whisper's encoder: the Conv1D stem (both convs tagged on the
        outer tagger ``tg``) and the full-attention stack.  mels: (B,
        2*encoder_seq, n_mels) raw log-mel frames."""
        cfg = self.cfg
        eps = cfg.norm_eps
        x = conv(tg, "enc.conv1", params["enc_conv1"], mels.float(),
                 spatial=(3,), stride=(1,), padding="SAME")
        x = F.gelu(x, approximate="tanh")
        x = conv(tg, "enc.conv2", params["enc_conv2"], x, spatial=(3,),
                 stride=(2,), padding="SAME")
        h = F.gelu(x, approximate="tanh")
        h = h + sinusoid_posemb(h.shape[1], cfg.d_model, h.device)[None]
        n = cfg.encoder_layers
        names = self.enc_tag_names
        recs = []
        for p, prs in zip(_groups(params["enc_blocks"], n),
                          self._group_probes(probes, "enc.", n)):
            tg_g = Tagger(mode, prs)
            h = h + self._attn_train(tg_g, names["attn"], p["attn"],
                                     rms_norm(h, p["ln1"], eps), None,
                                     window=0, causal=False)
            h = h + self._mlp_train(tg_g, names["mlp"], p["mlp"],
                                    rms_norm(h, p["ln2"], eps))
            recs.append(tg_g.out())
        return rms_norm(h, params["enc_final_ln"], eps), _stack_records(recs)

    def _backbone(self, params, x, positions, mode, probes, enc_out=None):
        ng = self.n_groups
        groups = [_groups(params["blocks"][i], ng)
                  for i in range(self.period)]
        h, recs = x, []
        for g, prs in enumerate(self._group_probes(probes, "blk", ng)):
            tg_g = Tagger(mode, prs)
            for i, spec in enumerate(self.pattern):
                h = self._block_train(spec, tg_g, groups[i][g], h, positions,
                                      enc_out)
            recs.append(tg_g.out())
        return h, _stack_records(recs)

    def _prepare_inputs(self, params, batch, tg, probes, mode):
        """Embed the tokens (tagged) and run the modality frontend.  Returns
        (x, positions, labels, mask, enc_out, frontend records)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        t = tokens.shape[1]
        labels = batch["labels"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, device=labels.device)
        x = tg.tag_embed("embed", tokens, params["embed"][tokens.long()],
                         mask)
        enc_out, extra = None, {}
        if cfg.frontend == "audio":
            enc_out, extra = self._encoder(params, batch["mels"], tg, mode,
                                           probes)
            x = x + sinusoid_posemb(t, cfg.d_model, x.device)[None]
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions, labels, mask, enc_out, extra

    def loss(self, params, probes, batch, rng, mode: str = "plain"):
        """Returns ``((loss_true, loss_sampled), {"recs": records,
        "metrics": {"loss": loss_true}})``; ``rng`` is the head's uniforms
        (``models/head.py``), None in the plain passes."""
        cfg = self.cfg
        tg = Tagger(mode, probes, self.contract_map, self.gcontract_map)
        x, positions, labels, mask, enc_out, extra = self._prepare_inputs(
            params, batch, tg, probes, mode)
        h, recs = self._backbone(params, x, positions, mode, probes, enc_out)
        h = rms_norm(h, params["final_ln"], cfg.norm_eps)
        lt, ls = lm_head_loss(
            tg, h, self.head_weight(params), labels, mask, rng,
            logit_cap=cfg.logit_softcap,
            name=None if cfg.tie_embeddings else "lm_head")
        return (lt, ls), {"recs": merge_records(tg.out(), recs, extra),
                          "metrics": {"loss": lt}}

    def hidden(self, params, batch):
        """Final normed hidden states (for exact-Fisher J-products, App C);
        returns (h, labels, mask)."""
        x, positions, labels, mask, enc_out, _ = self._prepare_inputs(
            params, batch, _PLAIN, None, "plain")
        h, _ = self._backbone(params, x, positions, "plain", None, enc_out)
        return rms_norm(h, params["final_ln"], self.cfg.norm_eps), labels, mask

    # ------------------------------------------------------------------
    # probes
    # ------------------------------------------------------------------
    def probe_shapes(self, batch) -> Dict[str, tuple]:
        """Shape of every tagged layer's output (its zero probe), from the
        batch's shapes alone."""
        cfg = self.cfg
        b, t = batch["tokens"].shape
        t_enc = t_mel = 0
        if cfg.frontend == "audio":
            t_mel = batch["mels"].shape[1]
            t_enc = conv_out_len(t_mel, 3, 2, "SAME")
        shapes = {}
        for name, m in self.metas.items():
            if m.kind == "head":
                continue
            if m.kind == "conv":
                tl = conv_out_len(t_mel, m.conv_spatial[0],
                                  m.conv_stride[0], m.conv_pad)
            elif name.startswith("enc.") or name.endswith(
                    (".cross.k", ".cross.v")):
                tl = t_enc
            else:
                tl = t
            lead = (m.n_stack,) if m.n_stack else ()
            shapes[name] = (*lead, b, tl, m.d_out)
        return shapes

    def make_probes(self, batch) -> Dict[str, torch.Tensor]:
        """Zero probes that require grad: their gradient is dL/ds."""
        return {k: torch.zeros(v, device=self.device, requires_grad=True)
                for k, v in self.probe_shapes(batch).items()}

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
