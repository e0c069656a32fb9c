"""The port's KFC convolutions and backward-pass fused statistics against
the JAX reference, module by module, on the CPU: the 2-D im2col, the conv
forward and its metas, ``SyntheticImageData``, ``ConvNet`` (logits, both
losses, the categorical samples, probes), ``ConvKronecker``'s factor
update on 1-D and 2-D records, the Tagger's contraction hooks, the fused
``{"gg"}`` probe (``core/fused.py::apply_gprobe``) and the fused factors
against the two-pass ones.

Inputs are made from numpy seeds; JAX's own draws (its ``init_params``
and the uniforms behind ``jax.random.categorical``) are handed to the port
as numpy.  Tolerances: data movement (im2col, the data) bitwise; one
forward or one factor update rtol 1e-5 with an atol of 1e-5 of the
array's largest magnitude; fused against two-pass factors rtol 1e-5 (the
reference's ``tests/test_autotune.py`` pins the same).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.conv_classifier import CONFIG as J_CONV
from repro.configs.conv_classifier import reduced as j_conv_reduced
from repro.core.blocks.conv import ConvKronecker as JConvKronecker
from repro.core.tags import Tagger as JTagger
from repro.data.pipeline import SyntheticImageData as JImageData
from repro.models import conv as jconv
from repro.models.convnet import ConvNet as JConvNet
from repro.models.mlp import MLP as JMLP
from repro.optimizers.kfac import KFACEngine as JEngine
from repro_torch import kernels as K
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig
from repro_torch.configs.conv_classifier import CONFIG, reduced
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.core import fused as FU
from repro_torch.core.blocks import ConvKronecker, resolve
from repro_torch.core.tags import Tagger
from repro_torch.data.pipeline import (SyntheticAutoencoderData,
                                       SyntheticImageData)
from repro_torch.models import conv
from repro_torch.models.convnet import ConvNet
from repro_torch.models.head import _TINY
from repro_torch.models.lm import LM
from repro_torch.models.mlp import MLP
from repro_torch.optimizers.kfac import KFACEngine
from test_torch_tridiag import _close, _close_tree, _np, _t

torch.set_num_threads(1)

N_IMG, DATA_SEED = 128, 7
MLP_DIMS = [16, 16, 8, 16, 16]


def _cat_uniforms(seed, step, shape):
    """The uniforms behind ``jax.random.categorical``'s Gumbel noise of the
    statistics pass of step ``step`` (``gumbel`` draws them on [tiny, 1))."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 1)
    return torch.from_numpy(np.array(jax.random.uniform(
        key, shape, jnp.float32, minval=_TINY, maxval=1.0)))


def _step_key(step, seed=0):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


def _convnet_setup():
    """The reduced conv classifier in both packages, JAX's weights carried
    across, and its data (N = 128, seed 7)."""
    jnet = JConvNet(j_conv_reduced())
    jparams = jnet.init_params(jax.random.PRNGKey(0))
    cfg = reduced()
    return dict(jnet=jnet, jparams=jparams, net=ConvNet(cfg, device="cpu"),
                params=params_from_numpy(_np(jparams), "cpu"),
                jdata=JImageData(cfg.image_size, cfg.channels,
                                 cfg.n_classes, N_IMG, seed=DATA_SEED),
                data=SyntheticImageData(cfg.image_size, cfg.channels,
                                        cfg.n_classes, N_IMG,
                                        seed=DATA_SEED, device="cpu"))


# ---------------------------------------------------------------------------
# models/conv.py: im2col, the forward, the metas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("side", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_extract_patches_2d_bitwise(padding, stride, side, c):
    """The tap-major 2-D im2col, ``k * C + c`` with k row-major over (kh,
    kw), bitwise JAX's (on a non-square image too: side × side+3)."""
    x = np.random.default_rng(side * 10 + c).standard_normal(
        (2, side, side + 3, c)).astype(np.float32)
    want = np.asarray(jconv.extract_patches(x, (3, 3), (stride, stride),
                                            padding))
    got = conv.extract_patches(torch.from_numpy(x), (3, 3), (stride, stride),
                               padding).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_same_padding_puts_the_odd_pad_high():
    """lax "SAME" at side 32, k 3: pads (0, 1) at stride 2, (1, 1) at 1."""
    assert conv.conv_pad_amounts(32, 3, 2, "SAME") == (0, 1)
    assert conv.conv_pad_amounts(32, 3, 1, "SAME") == (1, 1)
    assert conv.conv_out_len(32, 3, 2, "SAME") == 16


@pytest.mark.parametrize("stride", [1, 2])
def test_extract_patches_1d_unchanged(stride):
    """whisper's 1-D route through the same code, bitwise JAX's; a VALID
    conv shorter than its kernel gives no rows."""
    x = np.random.default_rng(3).standard_normal((2, 21, 5)).astype(
        np.float32)
    for padding in ("SAME", "VALID"):
        want = np.asarray(jconv.extract_patches(x, (3,), (stride,), padding))
        got = conv.extract_patches(torch.from_numpy(x), (3,), (stride,),
                                   padding).numpy()
        assert np.array_equal(got, want)
    short = torch.zeros(2, 2, 5)
    assert tuple(conv.extract_patches(short, (3,), (1,)).shape) == (2, 0, 15)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_forward(stride):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3 * 3 * 3 + 1, 5)).astype(np.float32)
    want = np.asarray(jconv.conv(JTagger("plain"), "c", w, x,
                                 spatial=(3, 3), stride=(stride, stride),
                                 padding="SAME"))
    got = conv.conv(Tagger("plain"), "c", torch.from_numpy(w),
                    torch.from_numpy(x), spatial=(3, 3),
                    stride=(stride, stride), padding="SAME")
    _close(got, want)


def test_conv_meta_fields_equal():
    for spatial, stride in (((3, 3), (2, 2)), ((3,), (1,))):
        want = jconv.conv_meta("c", ("c",), spatial=spatial, stride=stride,
                               c_in=3, d_out=32, padding="SAME")
        got = conv.conv_meta("c", ("c",), spatial=spatial, stride=stride,
                             c_in=3, d_out=32, padding="SAME")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the config, the data, the model
# ---------------------------------------------------------------------------

def test_config_mirrors_the_reference():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(J_CONV)
    assert dataclasses.asdict(reduced()) == dataclasses.asdict(
        j_conv_reduced())


@pytest.mark.parametrize("cfg_fn", [reduced, lambda: CONFIG],
                         ids=["reduced", "full"])
def test_synthetic_image_data_bitwise(cfg_fn):
    cfg = cfg_fn()
    jd = JImageData(cfg.image_size, cfg.channels, cfg.n_classes, 16, seed=7)
    d = SyntheticImageData(cfg.image_size, cfg.channels, cfg.n_classes, 16,
                           seed=7, device="cpu")
    for step in (0, 3):
        want, got = jd.batch(step), d.batch(step)
        assert got["x"].dtype == torch.float32
        assert got["y"].dtype == torch.int32
        assert tuple(got["x"].shape) == (16, cfg.image_size, cfg.image_size,
                                         cfg.channels)
        for k in ("x", "y"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("cfg_fn, jcfg_fn", [
    (reduced, j_conv_reduced), (lambda: CONFIG, lambda: J_CONV)],
    ids=["reduced", "full"])
def test_convnet_metas_and_probes(cfg_fn, jcfg_fn):
    jnet, net = JConvNet(jcfg_fn()), ConvNet(cfg_fn(), device="cpu")
    assert list(net.metas) == list(jnet.metas)
    for name in jnet.metas:
        assert (dataclasses.asdict(net.metas[name])
                == dataclasses.asdict(jnet.metas[name])), name
    cfg = cfg_fn()
    batch = SyntheticImageData(cfg.image_size, cfg.channels, cfg.n_classes,
                               4, device="cpu").batch(0)
    jshapes = jnet.probe_shapes({k: jnp.asarray(v.numpy())
                                 for k, v in batch.items()})
    probes = net.make_probes(batch)
    assert {k: tuple(v.shape) for k, v in probes.items()} == {
        k: tuple(v.shape) for k, v in jshapes.items()}
    assert all(p.requires_grad and not p.any() for p in probes.values())
    assert net.n_params() == jnet.n_params()
    # the port's own initializer: the reference's shapes, bias rows zero
    params = net.init_params(torch.Generator().manual_seed(0))
    for name, w in params.items():
        assert tuple(w.shape) == tuple(jnet.defs[name].shape)
        assert not w[-1].any()


def test_convnet_logits_and_losses():
    """JAX's weights carried across: logits and both losses within 1e-5,
    the sampled targets equal to ``jax.random.categorical``'s from its own
    uniforms, the accuracy equal."""
    s = _convnet_setup()
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    key = jax.random.PRNGKey(11)
    _close(s["net"].logits(s["params"], b["x"]),
           s["jnet"].logits(s["jparams"], jb["x"]))
    (jlt, jls), jaux = s["jnet"].loss(s["jparams"], None, jb, key)
    u = torch.from_numpy(np.array(jax.random.uniform(
        key, (N_IMG, reduced().n_classes), jnp.float32, minval=_TINY,
        maxval=1.0)))
    (lt, ls), aux = s["net"].loss(s["params"], None, b, lambda shape: u)
    _close(lt, jlt)
    _close(ls, jls)
    assert set(aux["metrics"]) == set(jaux["metrics"]) == {"loss",
                                                           "accuracy"}
    assert float(aux["metrics"]["accuracy"]) == float(
        jaux["metrics"]["accuracy"])
    z = s["net"].logits(s["params"], b["x"])
    want = np.asarray(jax.random.categorical(key, jnp.asarray(z.numpy()),
                                             axis=-1))
    got = s["net"].sample_targets(z, lambda shape: u).numpy()
    assert np.array_equal(got, want)
    (_, none), _ = s["net"].loss(s["params"], None, b, None)
    assert none is None


# ---------------------------------------------------------------------------
# ConvKronecker and the Tagger's hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 2])
def test_conv_kronecker_update_factors(nd):
    """One decayed factor update of a 1-D (patch_factor route) and a 2-D
    (explicit patches + factor_update) conv record against JAX's block."""
    rng = np.random.default_rng(20 + nd)
    spatial, stride = ((3,), (2,)) if nd == 1 else ((3, 3), (2, 2))
    shape = (4, 13, 5) if nd == 1 else (4, 9, 7, 5)
    jmeta = jconv.conv_meta("c", ("c",), spatial=spatial, stride=stride,
                            c_in=5, d_out=6, padding="SAME")
    meta = conv.conv_meta("c", ("c",), spatial=spatial, stride=stride,
                          c_in=5, d_out=6, padding="SAME")
    x = rng.standard_normal(shape).astype(np.float32)
    t_out = np.asarray(jconv.extract_patches(x, spatial, stride,
                                             "SAME")).shape[1]
    cot = (rng.standard_normal((4, t_out, 6)) * 1e-2).astype(np.float32)
    old = {"a": np.eye(meta.a_dim, dtype=np.float32) * 0.5,
           "g": np.eye(6, dtype=np.float32) * 0.25}
    eps, n = np.float32(0.75), 4
    jblk = JConvKronecker(jmeta, JKFACConfig())
    want = _np(jblk.update_factors(old, {"cx": x}, cot, None, n, eps))
    blk = ConvKronecker(meta, KFACConfig(), "cpu")
    assert resolve(meta) is ConvKronecker
    got = blk.update_factors({k: _t(v) for k, v in old.items()},
                             {"cx": _t(x)}, _t(cot), n, torch.tensor(eps))
    _close_tree(got, want)
    # stats_contrib: the reference's per-side contribution
    _close_tree(blk.stats_contrib({"cx": _t(x)}, _t(cot), n),
                _np(jblk.stats_contrib({"cx": x}, cot, None, n)))
    # an {"aa"} record and a {"gg"} gprobe: the fused blend, as JAX's
    aa = FU.conv_a_contract(meta)(_t(x))
    gg = FU.einsum_gg(_t(cot))
    want = _np(jblk.update_factors(old, {"aa": aa.numpy()},
                                   {"gg": gg.numpy()}, None, n, eps))
    got = blk.update_factors({k: _t(v) for k, v in old.items()},
                             {"aa": aa}, {"gg": gg}, n, torch.tensor(eps))
    _close_tree(got, want)
    _close_tree(blk.stats_contrib({"aa": aa}, {"gg": gg}, n),
                _np(jblk.stats_contrib({"aa": aa.numpy()},
                                       {"gg": gg.numpy()}, None, n)))


def test_tagger_contract_hooks():
    """Collect mode records the contraction instead of the raw input;
    plain mode runs no contraction; a ``{"gg"}`` probe goes through its
    gcontract entry, and without one the tag raises."""
    calls = []

    def fn(a):
        calls.append(a.shape)
        return a.reshape(-1, a.shape[-1]).T @ a.reshape(-1, a.shape[-1])

    a = torch.randn(6, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 5, 3, generator=torch.Generator().manual_seed(1))
    plain = Tagger("plain", {}, {"d": fn, "c": fn})
    plain.tag("d", a, a)
    plain.tag_conv("c", x, x)
    assert calls == [] and plain.out() == {}
    tg = Tagger("collect", {}, {"d": fn})
    tg.tag("d", a, a)
    tg.tag_conv("c", x, x)
    assert set(tg.out()["d"]) == {"aa"} and set(tg.out()["c"]) == {"cx"}
    _close(tg.out()["d"]["aa"], (a.T @ a).numpy())
    probe = FU.gg_probe(conv.conv_meta("c", ("c",), spatial=(1,),
                                       stride=(1,), c_in=4, d_out=4), "cpu")
    s = a.clone()
    out = Tagger("collect", {"d": probe}, {},
                 {"d": FU.g_contract(conv.conv_meta(
                     "d", ("d",), spatial=(1,), stride=(1,), c_in=4,
                     d_out=4))}).tag("d", a, s)
    (out * out).sum().backward()
    _close(probe["gg"].grad, FU.einsum_gg(2 * s).numpy())
    with pytest.raises(KeyError, match="gcontract"):
        Tagger("collect", {"d": probe}).tag("d", a, s)


def test_apply_gprobe_gradient():
    """The probe's gradient is Σ cot cotᵀ of the raw cotangent the zero
    probe would get; the output is a new view equal to s, and s's own
    gradient passes through unchanged."""
    rng = np.random.default_rng(5)
    s0 = torch.from_numpy(rng.standard_normal((3, 7, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))

    def loss(t):
        return torch.tanh(t @ w).pow(2).sum()

    zero = torch.zeros_like(s0, requires_grad=True)
    s = s0.clone().requires_grad_(True)
    cot, ds_plain = torch.autograd.grad(loss(s + zero), [zero, s])
    gg = torch.zeros(4, 4, requires_grad=True)
    s2 = s0.clone().requires_grad_(True)
    out = FU.apply_gprobe(s2, gg, FU.einsum_gg)
    assert out is not s2 and torch.equal(out, s2)
    assert out._base is s2
    g_gg, g_s = torch.autograd.grad(loss(out), [gg, s2])
    _close(g_gg, FU.einsum_gg(cot).numpy())
    assert torch.equal(g_s, ds_plain)
    # the g_contract hook: factor_update at α 1, β 0, same sums
    meta = conv.conv_meta("c", ("c",), spatial=(1,), stride=(1,), c_in=4,
                          d_out=4)
    _close(FU.g_contract(meta)(cot), FU.einsum_gg(cot).numpy())


# ---------------------------------------------------------------------------
# the engine: fused_stats wiring, and fused factors against two-pass ones
# ---------------------------------------------------------------------------

def test_config_accepts_fused_stats():
    assert KFACConfig(fused_stats=True).fused_stats


def test_lm_refuses_fused_stats():
    """``fused_stats`` on an LM: the engine builds, and only whisper's two
    conv stems (unstacked, full/full) are eligible, as in the reference;
    the model's hook maps stay empty outside a statistics pass."""
    lm = LM(get_reduced_config("whisper-small"), device="cpu")
    eng = KFACEngine(lm, KFACConfig(fused_stats=True), device="cpu")
    assert eng.fused_names == {"enc.conv1", "enc.conv2"}
    assert lm.contract_map == {} and lm.gcontract_map == {}
    assert not KFACEngine(lm, KFACConfig(), device="cpu").fused_names


def _mlp(fused, inv_mode):
    jmlp = JMLP(MLP_DIMS, nonlin="tanh", loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=False)
    from repro.data.pipeline import SyntheticAutoencoderData as JData
    kw = dict(inv_mode=inv_mode, fused_stats=fused)
    mlp = MLP(MLP_DIMS, device="cpu")
    return dict(
        jeng=JEngine(jmlp, JKFACConfig(**kw), family="bernoulli"),
        eng=KFACEngine(mlp, KFACConfig(**kw), family="bernoulli",
                       device="cpu"),
        jparams=jparams, params=params_from_numpy(_np(jparams), "cpu"),
        jbatch=JData(MLP_DIMS[0], 8, 256, seed=7).batch(0),
        batch=SyntheticAutoencoderData(MLP_DIMS[0], 8, 256, seed=7,
                                       device="cpu").batch(0),
        uniforms=lambda step, shape: _bern_uniforms(step, shape))


def _bern_uniforms(step, shape):
    key = jax.random.fold_in(_step_key(100 + step), 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def _convnet(fused, inv_mode):
    s = _convnet_setup()
    kw = dict(inv_mode=inv_mode, fused_stats=fused)
    return dict(
        jeng=JEngine(JConvNet(j_conv_reduced()), JKFACConfig(**kw),
                     family="categorical"),
        eng=KFACEngine(ConvNet(reduced(), device="cpu"), KFACConfig(**kw),
                       family="categorical", device="cpu"),
        jparams=s["jparams"], params=s["params"],
        jbatch=s["jdata"].batch(0), batch=s["data"].batch(0),
        uniforms=lambda step, shape: _cat_uniforms(0, 100 + step, shape))


def _stats(setup, steps=3, jax_too=False):
    """``steps`` stats passes from the init state (JAX's keys 100 + step);
    the port's state, and JAX's with ``jax_too``."""
    eng, params, batch = setup["eng"], setup["params"], setup["batch"]
    state = eng.init(params, batch)
    for step in range(steps):
        state, _, _ = eng.stats_grads(
            state, params, batch,
            lambda shape, step=step: setup["uniforms"](step, shape))
    if not jax_too:
        return state, None
    jeng = setup["jeng"]
    jstate = jeng.init(setup["jparams"], setup["jbatch"])
    for step in range(steps):
        jstate, _, _ = jax.jit(jeng.stats_grads)(
            jstate, setup["jparams"], setup["jbatch"], _step_key(100 + step))
    return state, jstate


@pytest.mark.parametrize("inv_mode", ["blkdiag", "eigen"])
@pytest.mark.parametrize("model", ["mlp", "convnet"])
def test_fused_stats_match_two_pass(model, inv_mode):
    """Three stats passes: the port's fused factors equal its two-pass
    factors to rtol 1e-5 (the reference's ``test_autotune.py`` pin), and
    JAX's fused factors to rtol 1e-5; every eligible layer fused."""
    make = _mlp if model == "mlp" else _convnet
    two, one = make(False, inv_mode), make(True, inv_mode)
    assert one["eng"].fused and one["eng"].fused_names == set(
        one["eng"].metas) == one["jeng"].fused_names
    assert not two["eng"].fused_names
    s0, _ = _stats(two)
    s1, j1 = _stats(one, jax_too=True)
    for name in s0.factors:
        for side in ("a", "g"):
            _close(s1.factors[name][side], s0.factors[name][side].numpy())
            _close(s1.factors[name][side], np.asarray(j1.factors[name][side]))


def test_fused_probes_are_tiny():
    eng = _convnet(True, "blkdiag")["eng"]
    probes = eng._probes(_convnet_setup()["data"].batch(0))
    for name in eng.fused_names:
        p = probes[name]
        g = eng.metas[name].g_dim
        assert set(p) == {"gg"} and tuple(p["gg"].shape) == (g, g)
        assert p["gg"].requires_grad


def test_fused_hooks_follow_the_reference():
    """tridiag disables fusion on a chain model (the MLP); the ConvNet has
    no chain, so tridiag keeps it, as in the reference; the engine holds a
    hook a side for every layer and leaves the model's maps empty."""
    tri = _mlp(True, "tridiag")
    assert not tri["eng"].fused and not tri["eng"].fused_names
    assert not tri["jeng"].fused
    net = ConvNet(reduced(), device="cpu")
    eng = KFACEngine(net, KFACConfig(inv_mode="tridiag", fused_stats=True),
                     family="categorical", device="cpu")
    jeng = JEngine(JConvNet(j_conv_reduced()),
                   JKFACConfig(inv_mode="tridiag", fused_stats=True),
                   family="categorical")
    assert eng.fused and eng.fused_names == jeng.fused_names
    assert set(eng.contract) == set(eng.gcontract) == set(net.metas)
    assert net.contract_map == {} and net.gcontract_map == {}


def test_fused_engine_leaves_the_model_as_it_was():
    """A fused engine puts its hooks on the model for its statistics pass
    alone: a two-pass engine built on the same model afterwards gets raw
    records and the factors of a two-pass engine on a model of its own."""
    one = _convnet(True, "blkdiag")
    net = one["eng"].model
    _stats(one, steps=1)
    assert net.contract_map == {} and net.gcontract_map == {}
    two = _convnet(False, "blkdiag")
    shared = dict(two, eng=KFACEngine(net, KFACConfig(inv_mode="blkdiag"),
                                      family="categorical", device="cpu"))
    want, _ = _stats(two, steps=1)
    got, _ = _stats(shared, steps=1)
    for name in want.factors:
        for side in ("a", "g"):
            assert torch.equal(got.factors[name][side],
                               want.factors[name][side])


def test_dense_kronecker_refuses_a_mixed_fused_pair():
    """An ``{"aa"}`` record comes with a ``{"gg"}`` gprobe and a raw record
    with a raw cotangent; a mixed pair is refused."""
    meta = conv.conv_meta("c", ("c",), spatial=(3, 3), stride=(1, 1),
                          c_in=2, d_out=4, padding="SAME")
    blk = ConvKronecker(meta, KFACConfig(), "cpu")
    old = blk.init_factors()
    x = torch.randn(2, 5, 5, 2, generator=torch.Generator().manual_seed(0))
    cot = torch.randn(2, 25, 4, generator=torch.Generator().manual_seed(1))
    aa = torch.eye(meta.a_dim)
    gg = {"gg": torch.eye(4)}
    for rec, gp in (({"aa": aa}, cot), ({"cx": x}, gg)):
        with pytest.raises(ValueError, match="come together"):
            blk.update_factors(old, rec, gp, 8, torch.tensor(0.5))


def test_grads_only_runs_no_contraction():
    """The ``stats_period`` skip runs the plain pass only: no contraction
    hook is called; a stats pass calls each once."""
    setup = _convnet(True, "blkdiag")
    eng = setup["eng"]
    net = eng.model
    calls = []
    for maps in (eng.contract, eng.gcontract):
        for name, fn in list(maps.items()):
            maps[name] = (lambda f, tag: lambda x: (calls.append(tag),
                                                    f(x))[1])(fn, name)
    state = eng.init(setup["params"], setup["batch"])
    state, _, m = eng.grads_only(state, setup["params"], setup["batch"],
                                 None)
    assert calls == [] and set(m) == {"loss", "accuracy"}
    eng.stats_grads(state, setup["params"], setup["batch"],
                    lambda shape: setup["uniforms"](0, shape))
    assert sorted(calls) == sorted(list(net.metas) * 2)


def test_stats_grads_from_jax_state():
    """One stats pass of the ConvNet from JAX's state: gradients, metrics
    and factors (two-pass and fused) against JAX's."""
    for fused in (False, True):
        setup = _convnet(fused, "blkdiag")
        jeng, eng = setup["jeng"], setup["eng"]
        _, jstate = _stats(setup, steps=1, jax_too=True)
        js, jgrads, jm = jax.jit(jeng.stats_grads)(
            jstate, setup["jparams"], setup["jbatch"], _step_key(101))
        st, grads, m = eng.stats_grads(
            state_from_numpy(vars(_np(jstate)), "cpu"), setup["params"],
            setup["batch"], lambda shape: setup["uniforms"](1, shape))
        assert set(m) == set(jm) == {"loss", "accuracy", "loss_sampled"}
        for k in m:
            _close(m[k], jm[k])
        _close_tree(grads, _np(jgrads))
        _close_tree(st.factors, _np(js.factors))


def test_cpu_contractions_launch_nothing():
    """On CPU tensors the contractions take the plain versions: no launch
    is counted."""
    K.reset_launches()
    setup = _convnet(True, "eigen")
    _stats(setup, steps=1)
    assert not any(K.launches().values())
