"""The port's K-FAC training of gemma2-2b against the JAX reference, module
by module, on the reduced config (2 layers, one local/global pair; d 64,
4 query heads over 2 KV heads of 16, d_ff 128, vocab 256, window 16,
attention softcap 50, logit softcap 30, tied embeddings; batch 8, seq 64)
on the CPU, in float32 as the reference launcher builds its LM.

gemma2-2b's d_ff of 9216 is the first side above the default
``max_factor_dim`` (8192): two blocks of 4608.  The reduced model gets
block sides from a small ``max_factor_dim``, as the reference's
``LM(cfg, KFACConfig(max_factor_dim=m))``: at 64 the MLP's d_ff sides
split in 2 blocks; at 48 d_model splits in 2 and d_ff in 4, so there are
block/block pairs and block/full pairs (the K/V maps' 32-wide G).

JAX's ``LM.init_params(PRNGKey(0))`` is carried across, the data are the
reference's numpy token stream (bitwise), and the head's sampling noise is
JAX's (``test_torch_whisper_parity._head_uniforms``).  Held here: the
metas field for field (``a_blocks`` / ``g_blocks`` among them) at reduced
and full width; ``attention_train`` with the window and the cap under
backward and ``jvp``; the capped loss, ``hidden``, gradients, records and
probe cotangents; the factors after two statistics passes at both block
counts; ``quad_lm`` with two tangents; the sampled targets bitwise
``jax.random.categorical``'s over the capped logits at vocab 256 and
256,000; the tied head's capped loss at vocab 256,000; the refresh
planner with blocks; block-shaped checkpoints across the packages.

Tolerances: per operation rtol 1e-5 with an atol of 1e-5 of the array's
largest magnitude; targets and checkpoints bitwise.  ``Trainer.fit`` is
held in ``test_torch_gemma2_trajectory.py``, the launcher in
``test_torch_gemma2_launch.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs import get_config as j_config
from repro.configs import get_reduced_config as j_reduced
from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import fisher as jfisher
from repro.core.tags import Tagger as JTagger
from repro.data.pipeline import SyntheticLMData as JLMData
from repro.distributed import plan as jplan
from repro.models import head as jhead
from repro.models import layers as jlayers
from repro.models.lm import LM as JLM
from repro.optimizers.kfac import KFACEngine as JEngine
from repro.training.checkpoint import Checkpointer as JCheckpointer
from repro.training.checkpoint import _flatten as jflatten
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import KFACConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import factors, fisher
from repro_torch.core.tags import Tagger
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed import plan
from repro_torch.launch import train as tlaunch
from repro_torch.models import head, layers
from repro_torch.models.lm import LM
from repro_torch.optimizers.kfac import KFACEngine, kfac
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.utils import tree as T
from repro_torch.utils.tree import flatten_with_keys
from test_torch_decoder_layers import assert_metas_agree
from test_torch_whisper_parity import (_close, _close_tree, _head_uniforms,
                                       _key, _np)

torch.set_num_threads(1)

ARCH = "gemma2-2b"
BATCH, SEQ = 8, 64
BLOCK_DIMS = (64, 48)            # max_factor_dim of the reduced block runs
KFAC = dict(lambda_init=10.0, t3=5)   # the reference launcher's


@functools.lru_cache(maxsize=None)
def _weights():
    jp = JLM(j_reduced(ARCH)).init_params(jax.random.PRNGKey(0))
    return jp, lm_params_from_numpy(_np(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(mfd=8192):
    jcfg = j_reduced(ARCH)
    cfg = get_reduced_config(ARCH)
    jp, params = _weights()
    data = tlaunch._ArchData(cfg, SyntheticLMData(cfg.vocab_size, SEQ, BATCH,
                                                  device="cpu"))
    return dict(jl=JLM(jcfg, JKFACConfig(max_factor_dim=mfd)), jp=jp,
                jdata=JLMData(jcfg.vocab_size, SEQ, BATCH),
                lm=LM(cfg, KFACConfig(max_factor_dim=mfd), device="cpu"),
                params=params, data=data, mfd=mfd)


def _grad_leaves(lm, params, batch):
    p1 = T.tree_map(lambda v: v.detach().requires_grad_(True), params)
    (lt, _), _ = lm.loss(p1, None, batch, None, mode="plain")
    return lt, T.tree_unflatten_like(params, torch.autograd.grad(
        lt, T.tree_leaves(p1)))


# ---------------------------------------------------------------------------
# the metas
# ---------------------------------------------------------------------------

def _sides(metas):
    return {n: (m.a_kind, m.a_blocks, m.g_kind, m.g_blocks)
            for n, m in metas.items()}


@pytest.mark.parametrize("mfd", [8192, *BLOCK_DIMS])
def test_reduced_metas_are_the_reference(mfd):
    s = _setup(mfd)
    assert_metas_agree(s["lm"].metas, s["jl"].metas)
    sides = _sides(s["lm"].metas)
    if mfd == 8192:
        assert all(k in ("full", "diag") for v in sides.values()
                   for k in v[::2])
    if mfd == 64:
        assert sides["blk0.mlp.up"] == ("full", 1, "block", 2)
        assert sides["blk1.mlp.down"] == ("block", 2, "full", 1)
    if mfd == 48:
        assert sides["blk0.attn.q"] == ("block", 2, "block", 2)
        assert sides["blk0.attn.k"] == ("block", 2, "full", 1)
        assert sides["blk1.mlp.gate"] == ("block", 2, "block", 4)
    assert sides["embed"] == ("diag", 1, "full", 1)


def test_full_width_metas_are_the_reference():
    """Full-width gemma2-2b (only the configs are built): the d_ff sides
    of gate, up (G) and down (Ā) are two blocks of 4608, every other side
    full, the tied embedding's Ā diagonal; field for field the
    reference's."""
    lm = LM(get_config(ARCH), device="cpu")
    assert_metas_agree(lm.metas, JLM(j_config(ARCH)).metas)
    sides = _sides(lm.metas)
    for pos in (0, 1):
        assert sides[f"blk{pos}.mlp.gate"] == ("full", 1, "block", 2)
        assert sides[f"blk{pos}.mlp.up"] == ("full", 1, "block", 2)
        assert sides[f"blk{pos}.mlp.down"] == ("block", 2, "full", 1)
        assert sides[f"blk{pos}.attn.q"] == ("full", 1, "full", 1)
    assert lm.metas["blk0.mlp.down"].n_stack == 13


@pytest.mark.parametrize("mfd", BLOCK_DIMS)
@pytest.mark.parametrize("n", [1, 5])
def test_refresh_plan_with_blocks_is_the_reference(mfd, n):
    """The staggered refresh's d³ costs, owners and groups from the block
    metas equal the reference planner's."""
    s = _setup(mfd)
    blocks = KFACEngine(s["lm"], KFACConfig(**KFAC, max_factor_dim=mfd),
                        device="cpu").blocks
    jblocks = JEngine(s["jl"], JKFACConfig(**KFAC, max_factor_dim=mfd)
                      ).blocks
    got, want = plan.build_plan(blocks, n), jplan.build_plan(jblocks, n)
    assert dict(got.costs) == dict(want.costs)
    assert dict(got.owners) == dict(want.owners)
    assert got.groups() == want.groups()


def test_data_param_tree_and_probe_shapes_are_the_reference():
    s = _setup(48)
    cfg = s["lm"].cfg
    assert cfg.tie_embeddings and cfg.alt_local_global
    assert (cfg.sliding_window, cfg.attn_softcap, cfg.logit_softcap) == (
        16, 50.0, 30.0)
    for step in (0, 3):
        jb, b = s["jdata"].batch(step), s["data"].batch(step)
        for k in jb:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    assert s["lm"].n_params() == s["jl"].n_params()
    assert [s.attn for s in s["lm"].pattern] == ["local", "global"]
    assert s["lm"].probe_shapes(s["data"].batch(0)) == {
        k: v.shape for k, v in s["jl"].probe_shapes(
            s["jdata"].batch(0)).items()}


# ---------------------------------------------------------------------------
# gemma2's layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_chunk", [256, 16])
def test_windowed_capped_attention_backward_and_jvp(q_chunk):
    """``attention_train`` with the reduced window (16) and the attention
    softcap (50), GQA 4 over 2, in one chunk and in query chunks of 16:
    its output, its backward against ``jax.vjp`` and its jvp against
    ``jax.jvp`` of the reference's ``attention``."""
    cfg = get_reduced_config(ARCH)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(2)
    # scores of a few units, so the cap bends them
    q, k, v = (3.0 * rng.standard_normal((2, SEQ, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    ct = rng.standard_normal((2, SEQ, hq, hd)).astype(np.float32)
    tans = [rng.standard_normal(x.shape).astype(np.float32)
            for x in (q, k, v)]
    kw = dict(causal=True, window=cfg.sliding_window, cap=cfg.attn_softcap,
              q_chunk=q_chunk)
    jf = lambda q, k, v: jlayers.attention(q, k, v, **kw)
    y, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    _, ydot = jax.jvp(jf, tuple(map(jnp.asarray, (q, k, v))),
                      tuple(map(jnp.asarray, tans)))
    f = lambda q, k, v: layers.attention_train(q, k, v, **kw)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = f(*ts)
    _close(got, y)
    for g, w in zip(torch.autograd.grad(got, ts, torch.from_numpy(ct)),
                    vjp(jnp.asarray(ct))):
        _close(g, w)
    _, gdot = torch.func.jvp(f, tuple(map(torch.from_numpy, (q, k, v))),
                             tuple(map(torch.from_numpy, tans)))
    _close(gdot, ydot)


@pytest.mark.parametrize("vocab", [256, 256_000])
def test_sampled_targets_are_jax_categorical(vocab):
    """The head's draw over capped logits (``30·tanh(z/30)``, the port's
    cap within 1e-5 of the reference's), on JAX's uniforms, is
    ``jax.random.categorical`` bit for bit on the same logits, on 2 × 32
    tokens at the reduced and the full vocab."""
    z = np.random.default_rng(vocab).standard_normal(
        (2, 32, vocab)).astype(np.float32) * 20.0
    logits = np.asarray(jlayers.softcap(jnp.asarray(z), 30.0))
    _close(layers.softcap(torch.from_numpy(z), 30.0), logits)
    key = jax.random.fold_in(_key(2), 1)
    want = np.asarray(jax.random.categorical(jax.random.split(key, 1)[0],
                                             jnp.asarray(logits), axis=-1))
    u = _head_uniforms(0, 2, (1, 2, 32, vocab))[0]
    got = head.sample_targets(torch.from_numpy(logits), u)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tied_capped_head_loss_at_full_vocab():
    """``lm_head_loss`` with the tied head (``name=None``) and the logit
    softcap at gemma2-2b's vocab of 256,000: both losses and the gradients
    of the hidden states and of the embedding against the reference's, on
    JAX's uniforms."""
    vocab, d = get_config(ARCH).vocab_size, 16
    rng = np.random.default_rng(5)
    h = (3.0 * rng.standard_normal((2, 16, d))).astype(np.float32)
    emb = rng.standard_normal((vocab, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.float32)
    rkey = jax.random.fold_in(_key(4), 1)

    def jf(h, emb):
        tg = JTagger("collect", None)
        lt, ls, _ = jhead.lm_head_loss(tg, h, emb.T, labels, mask, rkey,
                                       logit_cap=30.0, name=None)
        return lt + ls, (lt, ls)

    jgrads, (jlt, jls) = jax.grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(emb))
    ht, et = (torch.from_numpy(a).requires_grad_(True) for a in (h, emb))
    lt, ls = head.lm_head_loss(
        Tagger("collect", None), ht, et.T, torch.from_numpy(labels),
        torch.from_numpy(mask), lambda shape: _head_uniforms(0, 4, shape),
        logit_cap=30.0, name=None)
    _close(lt, jlt)
    _close(ls, jls)
    for g, w in zip(torch.autograd.grad(lt + ls, (ht, et)), jgrads):
        _close(g, w)


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

def test_capped_loss_hidden_and_grads():
    s = _setup()
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jloss = lambda p: s["jl"].loss(p, None, jb, _key(0))[0][0]
    jlt, jgrads = jax.jit(jax.value_and_grad(jloss))(s["jp"])
    (lt, ls), _ = s["lm"].loss(s["params"], None, b, None, mode="plain")
    _close(lt, jlt)
    assert float(ls) == 0.0
    jh = jax.jit(lambda p: s["jl"].hidden(p, jb)[0])(s["jp"])
    h, _, _ = s["lm"].hidden(s["params"], b)
    _close(h, jh)
    _close_tree(_grad_leaves(s["lm"], s["params"], b)[1], _np(jgrads))


def test_collect_records_and_probe_cotangents_with_blocks():
    """At max_factor_dim 48: the sampled loss, the probe cotangents, and
    each raw record contracted to its side's layout (block (S, nb, db,
    db) where the reference contracted it in its scan)."""
    s = _setup(48)
    jl, lm = s["jl"], s["lm"]
    jb, b = s["jdata"].batch(1), s["data"].batch(1)
    jprobes = jl.make_probes(jl.probe_shapes(jb))
    rng2 = jax.random.fold_in(_key(1), 1)

    def f(pr):
        (_, ls), aux = jl.loss(s["jp"], pr, jb, rng2, mode="collect")
        return ls, aux

    def vjp1(pr):
        y, fn, aux = jax.vjp(f, pr, has_aux=True)
        return y, fn(jnp.float32(1.0))[0], aux

    jls, jg, jaux = jax.jit(vjp1)(jprobes)
    probes = lm.make_probes(b)
    (_, ls), aux = lm.loss(s["params"], probes, b,
                           lambda shape: _head_uniforms(0, 1, shape),
                           mode="collect")
    g = dict(zip(probes, torch.autograd.grad(ls, list(probes.values()))))
    _close(ls, jls)
    _close_tree(g, _np(jg))
    jrecs, recs = _np(jaux["recs"]), aux["recs"]
    assert sorted(recs) == sorted(jrecs)
    for name, jr in jrecs.items():
        if "aa" not in jr:
            for k in jr:
                _close(recs[name][k], jr[k])
            continue
        m = lm.metas[name]
        aa = factors.outer_sum(recs[name]["a"], m.a_kind, stacked=True,
                               blocks=m.a_blocks)
        assert aa.shape == jr["aa"].shape
        _close(aa, jr["aa"])


@pytest.mark.parametrize("mfd", BLOCK_DIMS)
def test_factors_after_two_stats_passes(mfd):
    """Two stats passes (the second blends with eps = 1/2): every block's
    factors, block-shaped where the layout says so, the untagged params'
    diagonal curvature, the gradients and the sampled loss."""
    s = _setup(mfd)
    jeng = JEngine(s["jl"], JKFACConfig(**KFAC, max_factor_dim=mfd))
    eng = KFACEngine(s["lm"], KFACConfig(**KFAC, max_factor_dim=mfd),
                     device="cpu")
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jstate = jeng.init(s["jp"], jb)
    state = eng.init(s["params"], b)
    jstats = jax.jit(jeng.stats_grads)
    for step in range(2):
        jstate, jgrads, jm = jstats(jstate, s["jp"], jb, _key(step))
        state, grads, m = eng.stats_grads(
            state, s["params"], b,
            lambda shape, step=step: _head_uniforms(0, step, shape))
    meta = s["lm"].metas["blk0.mlp.down"]
    assert state.factors["blk0.mlp.down"]["a"].shape == (
        1, meta.a_blocks, 128 // meta.a_blocks, 128 // meta.a_blocks)
    _close_tree(state.factors, _np(jstate.factors))
    _close_tree(state.diag, _np(jstate.diag))
    _close_tree(grads, _np(jgrads))
    _close(m["loss_sampled"], jm["loss_sampled"])


def test_quad_lm_through_window_and_caps():
    """The exact-Fisher quadratic through the windowed, capped attention
    and the capped tied head, two tangents, and an embed-only one."""
    s = _setup()
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    rng = np.random.default_rng(3)
    tans = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2
                                    ).astype(np.float32), _np(s["jp"]))
            for _ in range(2)]
    jquad = jax.jit(lambda p, t: jfisher.quad_lm(s["jl"], p, jb, t))
    _close(fisher.quad_lm(s["lm"], s["params"], b,
                          [lm_params_from_numpy(t, "cpu") for t in tans]),
           jquad(s["jp"], tans))
    only = [jax.tree.map(np.zeros_like, t) for t in tans]
    for o, t in zip(only, tans):
        o["embed"] = t["embed"]
    _close(fisher.quad_lm(s["lm"], s["params"], b,
                          [lm_params_from_numpy(t, "cpu") for t in only]),
           jquad(s["jp"], only))


# ---------------------------------------------------------------------------
# block-shaped checkpoints across the packages
# ---------------------------------------------------------------------------

def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(got_flat, want_flat):
    assert set(got_flat) == set(want_flat)
    for k, v in got_flat.items():
        a, b = _host(v), _host(want_flat[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@functools.lru_cache(maxsize=None)
def _states():
    """(JAX tree, port tree, JAX template, port template) of reduced
    gemma2 at max_factor_dim 48 after two steps from the same start with
    the same draws: block-shaped factors and inverses on both sides."""
    s = _setup(48)
    kc = dict(**KFAC, max_factor_dim=48)
    jo = joptimizers.kfac(s["jl"], JKFACConfig(**kc))
    po = kfac(s["lm"], KFACConfig(**kc), device="cpu")
    jp, pp = s["jp"], s["params"]
    jtmpl = {"params": jp, "state": jo.init(jp, s["jdata"].batch(0))}
    ptmpl = {"params": pp, "state": po.init(pp, s["data"].batch(0))}
    js, ps = jtmpl["state"], ptmpl["state"]
    for step in range(2):
        jp, js, _ = jo.update(None, js, jp, s["jdata"].batch(step),
                              _key(step))
        pp, ps, _ = po.update(None, ps, pp, s["data"].batch(step),
                              lambda shape, step=step: _head_uniforms(
                                  0, step, shape))
    return {"params": jp, "state": js}, {"params": pp, "state": ps}, \
        jtmpl, ptmpl


def test_block_state_keys_shapes_and_dtypes_match():
    jtree, ptree, jtmpl, ptmpl = _states()
    sig = lambda flat: {k: (tuple(np.shape(v)), str(_host(v).dtype))
                        for k, v in flat.items()}
    assert sig(flatten_with_keys(ptree)) == sig(jflatten(jtree))
    assert sig(flatten_with_keys(ptmpl)) == sig(jflatten(jtmpl))
    shapes = {k: np.shape(v) for k, v in flatten_with_keys(ptree).items()}
    assert any(len(v) == 4 and "::factors::" in k for k, v in shapes.items())


def test_jax_block_checkpoint_restores_in_the_port(tmp_path):
    jtree, _, _, ptmpl = _states()
    JCheckpointer(str(tmp_path), async_save=False).save(5, jtree,
                                                        block=True)
    step, got = Checkpointer(str(tmp_path)).restore(ptmpl)
    assert step == 5
    _bitwise(flatten_with_keys(got), jflatten(jtree))


def test_port_block_checkpoint_restores_in_jax(tmp_path):
    _, ptree, jtmpl, _ = _states()
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(5, ptree)
    ck.wait()
    step, got = JCheckpointer(str(tmp_path)).restore(jtmpl)
    assert step == 5
    _bitwise(jflatten(got), flatten_with_keys(ptree))
