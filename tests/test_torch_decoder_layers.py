"""The layers the dense decoders (smollm-135m, llama3.2-1b) train through
and whisper's K-FAC training never reached, against the JAX reference on
the CPU: RoPE under autograd and under ``torch.func.jvp``, the causal
grouped-query ``attention_train`` with RoPE'd q and k under backward,
the head's sampled targets over the full vocabs, the tied head's loss
(``name=None``: no ``lm_head`` block; the head's gradient reaches
``embed`` through its transpose), and the full-width metas, whose factor
sides are all ``full`` (llama's 8192 is exactly the default
``KFACConfig.max_factor_dim``).

Tolerances: rtol 1e-5 with an atol of 1e-5 of the array's largest
magnitude; the sampled targets bitwise.  The model and the engine are
held in ``test_torch_decoder_parity.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs.base import KFACConfig as JKFACConfig
from repro.core.factors import factor_layout as j_layout
from repro.core.tags import Tagger as JTagger
from repro.models import head as jhead
from repro.models import layers as jlayers
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import KFACConfig
from repro_torch.core import factors
from repro_torch.core.tags import Tagger
from repro_torch.models import head, layers
from repro_torch.models.lm import LM
from test_torch_decoder_parity import ARCHS, SEQ
from test_torch_whisper_parity import _close, _head_uniforms, _key

torch.set_num_threads(1)


# the LayerMeta fields both packages' metas must agree on
META_FIELDS = ("param_path", "d_in", "d_out", "kind", "n_stack", "a_kind",
               "g_kind", "a_blocks", "g_blocks", "probe_tshard")


def assert_metas_agree(metas, jmetas):
    assert sorted(metas) == sorted(jmetas)
    for name, m in metas.items():
        for f in META_FIELDS:
            assert getattr(m, f) == getattr(jmetas[name], f), (name, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_metas_are_the_reference(arch):
    """Every factor side of the full-width decoder is ``full`` in both
    packages (llama's d_ff of 8192 is exactly the default
    ``max_factor_dim``), and the metas agree field for field; only the
    configs are built."""
    cfg = get_config(arch)
    jm = JLM(j_config(arch)).metas
    lm = LM(cfg, device="cpu")
    sides = {cfg.d_model, cfg.d_ff, cfg.kv_dim, cfg.q_dim}
    mfd = KFACConfig().max_factor_dim
    for side in sides:
        assert factors.factor_layout(side, False, 1, mfd) == ("full", 1)
        assert j_layout(side, False, 1, JKFACConfig().max_factor_dim) == (
            "full", 1)
    assert_metas_agree(lm.metas, jm)


@pytest.mark.parametrize("arch", ARCHS)
def test_rope_under_grad_and_jvp(arch):
    """``apply_rope`` at the arch's theta and head dim, its vjp and its jvp
    against JAX's."""
    cfg = get_reduced_config(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SEQ, cfg.n_heads, cfg.hd)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    tan = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.arange(SEQ)
    jf = lambda v: jlayers.apply_rope(v, jnp.asarray(pos), cfg.rope_theta)
    y, vjp = jax.vjp(jf, jnp.asarray(x))
    _, ydot = jax.jvp(jf, (jnp.asarray(x),), (jnp.asarray(tan),))
    f = lambda v: layers.apply_rope(v, torch.from_numpy(pos),
                                    cfg.rope_theta)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = f(xt)
    _close(got, y)
    (g,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    _close(g, vjp(jnp.asarray(ct))[0])
    _, gdot = torch.func.jvp(f, (torch.from_numpy(x),),
                             (torch.from_numpy(tan),))
    _close(gdot, ydot)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("q_chunk", [256, 16])
def test_rope_gqa_attention_train_backward(arch, q_chunk):
    """RoPE'd q and k through the causal GQA ``attention_train`` (one chunk,
    and query chunks of 16), its backward against ``jax.vjp`` of the
    reference's ``attention``."""
    cfg = get_reduced_config(arch)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, SEQ, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    ct = rng.standard_normal((2, SEQ, hq, hd)).astype(np.float32)
    pos = np.arange(SEQ)

    def jf(q, k, v):
        q = jlayers.apply_rope(q, jnp.asarray(pos), cfg.rope_theta)
        k = jlayers.apply_rope(k, jnp.asarray(pos), cfg.rope_theta)
        return jlayers.attention(q, k, v, causal=True, q_chunk=q_chunk)

    y, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    pt = torch.from_numpy(pos)
    got = layers.attention_train(
        layers.apply_rope(ts[0], pt, cfg.rope_theta),
        layers.apply_rope(ts[1], pt, cfg.rope_theta), ts[2], causal=True,
        q_chunk=q_chunk)
    _close(got, y)
    for g, w in zip(torch.autograd.grad(got, ts, torch.from_numpy(ct)),
                    want):
        _close(g, w)


@pytest.mark.parametrize("vocab", [49152, 128256])
def test_sampled_targets_are_jax_categorical(vocab):
    """The head's draw, ``argmax(logits + gumbel(u))`` on JAX's uniforms,
    is ``jax.random.categorical`` bit for bit over the full vocabs of
    smollm-135m (49152) and llama3.2-1b (128256)."""
    logits = np.random.default_rng(vocab).standard_normal(
        (2, 16, vocab)).astype(np.float32) * 3.0
    key = jax.random.fold_in(_key(2), 1)
    want = np.asarray(jax.random.categorical(jax.random.split(key, 1)[0],
                                             jnp.asarray(logits), axis=-1))
    u = _head_uniforms(0, 2, (1, 2, 16, vocab))[0]
    got = head.sample_targets(torch.from_numpy(logits), u)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_head_loss_at_full_vocab(arch):
    """``lm_head_loss`` with a tied head (``name=None``) at the arch's full
    vocab: both losses and the gradients of the hidden states and of the
    embedding (through its transpose) against the reference's, on JAX's
    uniforms; nothing is recorded for the head."""
    cfg = get_config(arch)
    d, vocab = 16, cfg.vocab_size
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 16, d)).astype(np.float32)
    emb = (rng.standard_normal((vocab, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.float32)
    rkey = jax.random.fold_in(_key(4), 1)

    def jf(h, emb):
        tg = JTagger("collect", None)
        lt, ls, _ = jhead.lm_head_loss(tg, h, emb.T, labels, mask, rkey,
                                       name=None)
        return lt + ls, (lt, ls, tg.records)

    jgrads, (jlt, jls, jrecs) = jax.grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(emb))
    assert not jrecs
    ht, et = (torch.from_numpy(a).requires_grad_(True) for a in (h, emb))
    tg = Tagger("collect", None)
    lt, ls = head.lm_head_loss(
        tg, ht, et.T, torch.from_numpy(labels), torch.from_numpy(mask),
        lambda shape: _head_uniforms(0, 4, shape), name=None)
    assert not tg.records
    _close(lt, jlt)
    _close(ls, jls)
    for g, w in zip(torch.autograd.grad(lt + ls, (ht, et)), jgrads):
        _close(g, w)
