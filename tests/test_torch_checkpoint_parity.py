"""Checkpoints and curvature bundles across the two packages, on the CPU:
each package writes, the other reads, through the files on disk.

States: the golden setup (``tests/test_golden.py::golden_run``'s config:
the reduced autoencoder 64-32-16-8 mirrored, eigh, λ₀ 3, T3 5, η 1e-5,
N 256, data seed 7, JAX's sparse-init weights) in blkdiag, eigen,
tridiag, the fused fixed-lr chain and the staggered refresh; reduced
whisper-small in the reference launcher's setup (λ₀ 10, T3 5, blkdiag
NS); SGD with momentum and Adam on the race config
(``benchmarks/bench_optimizer_race.py``).

- The flattened keys, shapes and dtypes of both packages' states are
  equal, and a checkpoint written by either restores in the other bit for
  bit.  tridiag's Ψ/Σ cache is written but restored as None by both: its
  template holds None before the first refresh.  A JAX checkpoint of the
  overlap refresh mode restores into a port serial template, its
  ``inv_pending`` leaves dropped.
- Resumed trajectories: JAX checkpoints the golden setup at step 7, and
  each package resumes from those files to step 20 with JAX's uniforms.
  Both re-arm the three warmup refreshes at step 7, so the port is held to
  JAX's *resumed* run, never to an uninterrupted one.  Step for step from
  JAX's state: the metrics within rtol 1e-3, parameters and factors 1e-4.
  Free-running, queue C's limit with its steps counted from the resume:
  λ and γ within 1e-6, the loss within 5e-3, α, μ and ρ within 1e-3
  through the fifth resumed step (the fused path's ρ, a difference of two
  losses near 90, within 1e-6 of the loss, as
  ``test_torch_eigen_fused_parity.py`` holds it).  Reduced whisper: 3
  steps, a checkpoint, 3 resumed steps, within the same bands.
- Bundles: each package loads the other's, arrays bit for bit and metas
  equal as ``dataclasses.asdict``, bfloat16 bases included (the port's bit
  patterns are ``ml_dtypes``'); a JAX whisper bundle, whose diagonal sides
  have no basis, loads in the port.  ``snapshot_bundle`` from JAX's
  carried eigen state is JAX's bundle bit for bit; from a blkdiag state it
  decomposes the factors itself, so it is compared through ``s``/``damp``
  and the preconditioned U of a fixed V (rtol 1e-4; the eigh basis is not
  unique, queue C).
"""
import dataclasses
import functools
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import inverse as jinverse
from repro.curvature import bundle as jbundle
from repro.models.mlp import MLP as JMLP
from repro.training.checkpoint import Checkpointer as JCheckpointer
from repro.training.checkpoint import _flatten as jflatten
from repro.training.trainer import Trainer as JTrainer
from repro_torch import optimizers
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import (lm_params_from_numpy, params_from_numpy,
                                 state_from_numpy)
from repro_torch.core import inverse
from repro_torch.curvature import bundle as pbundle
from repro_torch.models.mlp import MLP
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.trainer import Trainer
from repro_torch.utils.tree import flatten_with_keys
from test_torch_baselines import _setup as _race_setup
from test_torch_tridiag import _close, _np
from test_torch_tridiag_parity import _golden, _step_key, _uniforms
from test_torch_whisper_parity import _head_uniforms
from test_torch_whisper_parity import _setup as _whisper_setup

torch.set_num_threads(1)

GOLDEN = {
    "blkdiag": dict(inv_mode="blkdiag"),
    "eigen": dict(inv_mode="eigen"),
    "tridiag": dict(inv_mode="tridiag"),
    "fused": dict(inv_mode="blkdiag", use_rescale=False, fixed_lr=0.02,
                  fixed_momentum=0.9, kl_clip=1e-3),
    "staggered": dict(inv_mode="blkdiag", refresh_mode="staggered"),
}
KINDS = [*GOLDEN, "whisper", "sgd_momentum", "adam"]
KEYS = ("loss", "lam", "gamma", "alpha", "mu", "rho")
RESUME_AT, RESUME_TO = 7, 20
W_RESUME_AT, W_RESUME_TO = 3, 6
WHISPER_KFAC = dict(lambda_init=10.0, t3=5)


def _golden_cfg(mode):
    return dict(inverse_method="eigh", lambda_init=3.0, t3=5, eta=1e-5,
                **GOLDEN[mode])


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _signature(flat):
    return {k: (tuple(np.shape(v)), str(_host(v).dtype))
            for k, v in flat.items()}


def _bitwise(got_flat, want_flat):
    """Every leaf of ``got_flat`` is ``want_flat``'s, dtype and bits."""
    for k, v in got_flat.items():
        a, b = _host(v), _host(want_flat[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# every state kind the port builds, in both packages, after a few steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _states(kind):
    """(JAX tree, port tree, JAX template, port template): ``{"params",
    "state"}`` after two steps (whisper: one) from the same start with the
    same draws, and each package's fresh ``opt.init`` template."""
    if kind in GOLDEN:
        g = _golden()
        jo = joptimizers.kfac(g["jmlp"], JKFACConfig(**_golden_cfg(kind)),
                              family="bernoulli")
        po = kfac(g["mlp"], KFACConfig(**_golden_cfg(kind)),
                  family="bernoulli", device="cpu")
        jp, pp, jdata, data = g["jparams"], g["params"], g["jdata"], \
            g["data"]
        noise, steps = _uniforms, 2
    elif kind == "whisper":
        s = _whisper_setup()
        jo = joptimizers.kfac(s["jl"], JKFACConfig(**WHISPER_KFAC))
        po = kfac(s["lm"], KFACConfig(**WHISPER_KFAC), device="cpu")
        jp, pp, jdata, data = s["jp"], s["params"], s["jdata"], s["data"]
        noise, steps = _head_uniforms, 1
    else:
        s = _race_setup()
        jo = joptimizers.get(kind, s["jmlp"], lr=0.1)
        po = optimizers.get(kind, s["mlp"], lr=0.1)
        jp, pp, jdata, data = s["jparams"], s["params"], s["jdata"], \
            s["data"]
        noise, steps = _uniforms, 2
    jtmpl = {"params": jp, "state": jo.init(jp, jdata.batch(0))}
    ptmpl = {"params": pp, "state": po.init(pp, data.batch(0))}
    js, ps = jtmpl["state"], ptmpl["state"]
    for step in range(steps):
        jp, js, _ = jo.update(None, js, jp, jdata.batch(step),
                              _step_key(step))
        pp, ps, _ = po.update(None, ps, pp, data.batch(step),
                              lambda shape, step=step: noise(0, step, shape))
    return {"params": jp, "state": js}, {"params": pp, "state": ps}, \
        jtmpl, ptmpl


@pytest.mark.parametrize("kind", KINDS)
def test_flattened_keys_shapes_and_dtypes_match(kind):
    jtree, ptree, jtmpl, ptmpl = _states(kind)
    assert _signature(flatten_with_keys(ptree)) == _signature(
        jflatten(jtree))
    assert _signature(flatten_with_keys(ptmpl)) == _signature(
        jflatten(jtmpl))


def _restored_keys(kind, tree_flat):
    if kind == "tridiag":      # the template's cache is None
        assert not any("::__tri__::" in k for k in tree_flat)
    return set(tree_flat)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_restores_in_the_port(kind, tmp_path):
    jtree, _, _, ptmpl = _states(kind)
    JCheckpointer(str(tmp_path), async_save=False).save(5, jtree,
                                                        block=True)
    step, got = Checkpointer(str(tmp_path)).restore(ptmpl)
    assert step == 5
    flat = flatten_with_keys(got)
    assert _restored_keys(kind, flat) == set(flatten_with_keys(ptmpl))
    _bitwise(flat, jflatten(jtree))
    if kind == "tridiag":
        assert got["state"].inv["__tri__"] is None


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_restores_in_jax(kind, tmp_path):
    _, ptree, jtmpl, _ = _states(kind)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(5, ptree)
    ck.wait()
    step, got = JCheckpointer(str(tmp_path)).restore(jtmpl)
    assert step == 5
    flat = jflatten(got)
    assert _restored_keys(kind, flat) == set(jflatten(jtmpl))
    _bitwise(flat, flatten_with_keys(ptree))


def test_overlap_checkpoint_restores_into_a_serial_template(tmp_path):
    """A JAX checkpoint of ``refresh_mode="overlap"`` carries the second
    inverse buffer; a port serial template drops it, as the reference's
    ``test_checkpoint_refresh_mode_switch`` does."""
    jmlp = JMLP([16, 8, 16], loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=False)
    batch = {"x": jax.random.bernoulli(jax.random.PRNGKey(1), 0.5,
                                       (64, 16)).astype(np.float32)}
    batch["y"] = batch["x"]
    jo = joptimizers.kfac(jmlp, JKFACConfig(lambda_init=1.0,
                                            refresh_mode="overlap"),
                          family="bernoulli")
    js = jo.init(jparams, batch)
    jp, js, _ = jo.update(None, js, jparams, batch, jax.random.PRNGKey(1))
    assert js.inv_pending is not None
    JCheckpointer(str(tmp_path), async_save=False).save(
        1, {"params": jp, "state": js}, block=True)
    mlp = MLP([16, 8, 16], device="cpu")
    params = params_from_numpy(_np(jparams), "cpu")
    port = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    template = kfac(mlp, KFACConfig(lambda_init=1.0), family="bernoulli",
                    device="cpu").init(params, port)
    step, got = Checkpointer(str(tmp_path)).restore(
        {"params": params, "state": template})
    assert step == 1 and got["state"].inv_pending is None
    flat = flatten_with_keys(got)
    assert not any("inv_pending" in k for k in flat)
    _bitwise(flat, jflatten({"params": jp, "state": js}))


# ---------------------------------------------------------------------------
# resumed trajectories
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("resume")


_RUNS = {}


def _jax_resumed(root, kind):
    """JAX trains to ``at`` with a checkpoint there, then a new optimizer
    and trainer resume from a copy of those files to ``to``, each step's
    inputs and outputs recorded.  Returns (checkpoint dir, resumed
    history, record)."""
    if kind in _RUNS:
        return _RUNS[kind]
    if kind == "whisper":
        s = _whisper_setup()
        model, params, data = s["jl"], s["jp"], s["jdata"]
        make = lambda: joptimizers.kfac(model, JKFACConfig(**WHISPER_KFAC))
        at, to = W_RESUME_AT, W_RESUME_TO
    else:
        g = _golden()
        model, params, data = g["jmlp"], g["jparams"], g["jdata"]
        make = lambda: joptimizers.kfac(
            model, JKFACConfig(**_golden_cfg(kind)), family="bernoulli")
        at, to = RESUME_AT, RESUME_TO
    first = root / kind / "first"
    JTrainer(model, make(), JTrainConfig(steps=at, seed=0,
                                         checkpoint_every=at,
                                         log_every=10_000),
             None, JCheckpointer(str(first), async_save=False)).fit(
        params, data, steps=at, log=lambda *_: None)
    assert JCheckpointer(str(first)).all_steps() == [at]
    shutil.copytree(first, root / kind / "jax")
    opt, record, logs = make(), [], []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    hist = JTrainer(model, dataclasses.replace(opt, update=update),
                    JTrainConfig(steps=to, seed=0, checkpoint_every=at,
                                 log_every=10_000),
                    None, JCheckpointer(str(root / kind / "jax"),
                                        async_save=False)).fit(
        params, data, steps=to, log=logs.append)["history"]
    assert f"[trainer] restored checkpoint at step {at}" in logs
    assert len(hist) == to - at
    _RUNS[kind] = (first, hist, record)
    return _RUNS[kind]


def _port_setup(kind):
    """(model, port optimizer, params template, data, noise, to)."""
    if kind == "whisper":
        s = _whisper_setup()
        return (s["lm"], kfac(s["lm"], KFACConfig(**WHISPER_KFAC),
                              device="cpu"), s["params"], s["data"],
                _head_uniforms, W_RESUME_TO)
    g = _golden()
    return (g["mlp"], kfac(g["mlp"], KFACConfig(**_golden_cfg(kind)),
                           family="bernoulli", device="cpu"),
            g["params"], g["data"], _uniforms, RESUME_TO)


def _port_params(kind, jparams):
    return (lm_params_from_numpy(jparams, "cpu") if kind == "whisper"
            else params_from_numpy(jparams, "cpu"))


def _close_flat(got, want, rtol):
    g, w = flatten_with_keys(got), flatten_with_keys(want)
    assert set(g) == set(w)
    for k in w:
        _close(g[k], w[k], rtol)


@pytest.mark.parametrize("kind", [*GOLDEN, "whisper"])
def test_resumed_steps_match_jax_from_its_state(kind, root):
    """Step for step: each step of JAX's resumed run, given to the port
    from JAX's state and parameters with the same draws (the first one
    the restored state, whose warmup the port re-arms as JAX does)."""
    _, want, record = _jax_resumed(root, kind)
    model, opt, _, data, noise, _ = _port_setup(kind)
    for i, (jstate, jparams, jnew, jout) in enumerate(record):
        step = int(jstate.step)
        params = _port_params(kind, jparams)
        if i == 0:
            opt.init(params, data.batch(step))
        if kind == "tridiag" and i == 0:
            assert jstate.inv["__tri__"] is None
        new, state, m = opt.update(
            None, state_from_numpy(vars(jstate), "cpu"), params,
            data.batch(step),
            lambda shape, step=step: noise(0, step, shape))
        for k in (*KEYS, "nu"):
            assert (k in m) == (k in want[i]), (step, k)
            if k in m:
                assert float(m[k]) == pytest.approx(want[i][k],
                                                    rel=1e-3), (step, k)
        _close_flat(new, jnew, 1e-4)
        _close_flat(state.factors, jout.factors, 1e-4)
        assert int(state.step) == int(jout.step) == step + 1


@pytest.mark.parametrize("kind", [*GOLDEN, "whisper"])
def test_resumed_trajectory_matches_jax_resumed_run(kind, root):
    """Free-running: the port's ``Trainer.fit`` resumes from JAX's files
    (a copy of them) with JAX's draws, held to JAX's resumed run within
    queue C's limit, steps counted from the resume."""
    first, want, _ = _jax_resumed(root, kind)
    model, opt, params, data, noise, to = _port_setup(kind)
    at = to - len(want)
    shutil.copytree(first, root / kind / "port")
    ck = Checkpointer(str(root / kind / "port"), async_save=True)
    logs = []
    got = Trainer(model, opt, TrainConfig(steps=to, seed=0,
                                          checkpoint_every=at,
                                          log_every=10_000),
                  noise=lambda step, shape: noise(0, step, shape),
                  device="cpu", checkpointer=ck).fit(
        params, data, steps=to, log=logs.append)["history"]
    assert f"[trainer] restored checkpoint at step {at}" in logs
    assert len(got) == len(want) == to - at
    for i, (g, w) in enumerate(zip(got, want)):
        for k in (*KEYS, "nu"):
            assert (k in g) == (k in w), (i, k)
        for k in ("lam", "gamma"):
            assert g[k] == pytest.approx(w[k], rel=1e-6), (i, k)
        assert g["loss"] == pytest.approx(w["loss"], rel=5e-3), i
        if i > 4:
            continue
        for k in ("loss", "alpha", "mu", "rho"):
            if k not in w:
                continue
            if kind == "fused" and k == "rho":
                assert g[k] == pytest.approx(w[k], abs=1e-6 * w["loss"]), i
            else:
                assert g[k] == pytest.approx(w[k], rel=1e-3), (i, k)
    assert all(np.isfinite(h["loss"]) for h in got)
    rel = lambda k, n: max((abs(g[k] / w[k] - 1) for g, w in
                            zip(got[:n], want[:n]) if k in w), default=0.0)
    print(f"{kind}: resumed at {at}, largest relative difference: loss "
          f"{rel('loss', len(want)):.2e}; through 5 steps "
          + ", ".join(f"{k} {rel(k, 5):.2e}" for k in ("alpha", "mu", "rho")))
    # both resumed runs wrote their next checkpoint where JAX's did
    assert Checkpointer(str(root / kind / "port")).all_steps() == \
        JCheckpointer(str(root / kind / "jax")).all_steps()


# ---------------------------------------------------------------------------
# curvature bundles
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trained(mode):
    """The golden setup after 4 JAX steps (warmup refreshes and the
    rescale): (JAX engine, JAX state, port engine, JAX state carried into
    the port)."""
    g = _golden()
    jo = joptimizers.kfac(g["jmlp"], JKFACConfig(**_golden_cfg(mode)),
                          family="bernoulli")
    jp, js = g["jparams"], jo.init(g["jparams"], g["jdata"].batch(0))
    for step in range(4):
        jp, js, _ = jo.update(None, js, jp, g["jdata"].batch(step),
                              _step_key(step))
    po = kfac(g["mlp"], KFACConfig(**_golden_cfg(mode)), family="bernoulli",
              device="cpu")
    return jo.engine, js, po.engine, state_from_numpy(vars(_np(js)), "cpu")


def _same_bundles(got, want):
    """Bundle ``got`` (either package's, loaded) holds ``want``'s arrays
    bit for bit and equal metas and damping."""
    assert got.block_names == want.block_names
    assert (got.step, got.lam, got.gamma, got.eta) == (
        want.step, want.lam, want.gamma, want.eta)
    for name in want.block_names:
        assert dataclasses.asdict(got.metas[name]) == dataclasses.asdict(
            want.metas[name])
        for k, v in want.eigen[name].items():
            if v is None:
                assert got.eigen[name][k] is None, (name, k)
                continue
            a, b = _host(got.eigen[name][k]), _host(v)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {k}")
    assert set(got.diag) == set(want.diag)
    for k in want.diag:
        np.testing.assert_array_equal(_host(got.diag[k]),
                                      _host(want.diag[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_bundle_loads_in_the_port(dtype, tmp_path):
    jeng, js, _, _ = _trained("eigen")
    jbundle.save_bundle(jbundle.snapshot_bundle(jeng, js),
                        str(tmp_path / "b"), dtype=dtype)
    _same_bundles(pbundle.load_bundle(str(tmp_path / "b"), device="cpu"),
                  jbundle.load_bundle(str(tmp_path / "b")))
    assert pbundle.load_bundle(str(tmp_path / "b"),
                               device="cpu").metas == _golden()["mlp"].metas


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_bundle_loads_in_jax(dtype, tmp_path):
    _, _, peng, ps = _trained("eigen")
    bundle = pbundle.snapshot_bundle(peng, ps)
    pbundle.save_bundle(bundle, str(tmp_path / "b"), dtype=dtype)
    _same_bundles(jbundle.load_bundle(str(tmp_path / "b")),
                  pbundle.load_bundle(str(tmp_path / "b"), device="cpu"))
    if dtype == "float32":
        _same_bundles(jbundle.load_bundle(str(tmp_path / "b")), bundle)


def test_jax_whisper_bundle_loads_in_the_port(tmp_path):
    """An LM bundle from the reference: its diagonal sides (the embedding's
    Ā, the head's G) carry no basis, so ``qa`` or ``qg`` is None there."""
    s = _whisper_setup()
    jtree, _, _, _ = _states("whisper")
    jeng = joptimizers.kfac(s["jl"], JKFACConfig(**WHISPER_KFAC)).engine
    jbundle.save_bundle(jbundle.snapshot_bundle(jeng, jtree["state"]),
                        str(tmp_path / "b"))
    got = pbundle.load_bundle(str(tmp_path / "b"), device="cpu")
    _same_bundles(got, jbundle.load_bundle(str(tmp_path / "b")))
    assert got.eigen["embed"]["qa"] is None
    assert got.eigen["lm_head"]["qg"] is None
    # the reference marks its self-attention maps' probes for context
    # parallelism (probe_tshard), and so does the port's LM: every field
    # is the port's own meta
    assert got.metas == s["lm"].metas
    assert any(m.probe_tshard for m in got.metas.values())


def test_bf16_bit_patterns_are_ml_dtypes():
    """Round to nearest even, as ``ml_dtypes.bfloat16``: random values
    over many decades, exact ties both ways, subnormals, the largest
    finite values, zeros and infinities."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * np.exp(rng.uniform(
        -80, 80, 100_000))).astype(np.float32)
    bits = np.arange(0, 1 << 16, dtype=np.uint32) << 16
    ties = np.concatenate([bits | 0x8000, bits | 0x7FFF, bits | 0x8001,
                           bits]).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                        np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                       np.float32)
    for arr in (x, ties[np.isfinite(ties)], special):
        want = arr.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(pbundle.bf16_bits(arr), want)
        np.testing.assert_array_equal(
            pbundle.bf16_float(want),
            want.view(ml_dtypes.bfloat16).astype(np.float32))


def test_snapshot_of_a_carried_eigen_state_is_jax_bitwise():
    jeng, js, peng, ps = _trained("eigen")
    _same_bundles(pbundle.snapshot_bundle(peng, ps),
                  jbundle.snapshot_bundle(jeng, js))


def test_snapshot_of_a_blkdiag_state_matches_through_invariants():
    """From blkdiag factors each package runs its own eigh: ``s`` and
    ``damp`` (eigenvalues) and the apply to a fixed V agree, the bases
    need not."""
    jeng, js, peng, ps = _trained("blkdiag")
    want = jbundle.snapshot_bundle(jeng, js)
    got = pbundle.snapshot_bundle(peng, ps)
    assert (got.step, got.lam, got.gamma, got.eta) == (
        want.step, want.lam, want.gamma, want.eta)
    for name, meta in peng.metas.items():
        w = {k: np.asarray(v) for k, v in want.eigen[name].items()}
        for k in ("s", "damp"):
            _close(got.eigen[name][k], w[k], rtol=1e-4)
        v = np.random.default_rng(13).standard_normal(
            (meta.a_dim, meta.g_dim)).astype(np.float32)
        _close(inverse.apply_eigen(meta, got.eigen[name],
                                   torch.from_numpy(v)),
               np.asarray(jinverse.apply_eigen(jeng.metas[name], w, v)),
               rtol=1e-4)
