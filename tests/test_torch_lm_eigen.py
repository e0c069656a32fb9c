"""The eigen path (EKFAC) and the fused fixed-lr chain on the LM's layouts
against the JAX reference, module by module, on the CPU.

The layer metas are the reduced LMs' own (gemma2-2b's at
``max_factor_dim`` 64, where the MLP's d_ff sides are 2 blocks), the
factors made from
numpy seeds with spectra over two decades: stacked full/full (the
attention's q/k/v/o and the MLP), full/block and block/full (gemma2's
gate, up and down), diag/full (the embedding) and full/diag (whisper's
head).  Held here:

* ``eigh_basis`` on a full, a block and a diag side, stacked: the
  eigenvalues against JAX's, each factor rebuilt from ``(q, w)``;
* ``eigen_pair_state``'s ``s`` and ``damp`` right after a refresh on every
  layout, and the γ sweep's ``eigen_pair_multi`` with its (3, …) ``damp``;
* ``rotate_eigen`` both ways, ``apply_eigen`` and ``eigen_rescale`` from
  JAX's own bases carried across;
* ``eigen_identity``: its keys, its Nones (a diag side has no basis), its
  shapes and values equal to JAX's, on every block of each reduced LM;
* the eigen apply right after a refresh against the damped eigh inverse
  apply, within 5e-6·κ;
* the blocks: ``DenseKronecker``'s stacked eigen apply (the batched
  ``rotate_rescale`` route) and ``BlockDiagKronecker``'s (matmul with the
  blocks in the batch), and both chains, against JAX's blocks;
* the batched plain kernel versions: ``rotate_rescale_ref`` against JAX's
  interpret-mode ``rotate_rescale`` under ``jax.vmap`` at a stacked shape
  that tiles, ``precond_momentum_ref`` (D and ΣD²) against JAX's
  interpret-mode kernel slice by slice and against the reference's
  base-class composition;
* the wrappers' calls of the launcher's eigen, chain and ``fused_stats``
  runs on the reduced LMs, which on the card are their launches: equal to
  ``chip_smoke.py::lm_launches`` from the metas.

Tolerances: rtol 1e-5 with an atol of 1e-5 of the array's largest
magnitude; 1e-4 where each package runs its own eigendecomposition (the
bases differ in column signs, so only eigenvalues and applies compare).
The trajectories are in ``test_torch_lm_eigen_trajectory.py``,
``test_torch_lm_chain.py`` and ``test_torch_lm_fused.py``.
"""
import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import inverse as jinverse
from repro.core.blocks import base as jbase
from repro.kernels.update_chain import precond_momentum as j_precond_momentum
from repro.kernels.rotate_rescale import rotate_rescale as j_rotate_rescale
from repro.models.lm import LM as JLM
from repro.optimizers.kfac import KFACEngine as JEngine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig
from repro_torch.core import blocks as B
from repro_torch.core import inverse
from repro_torch.core.blocks import kron
from repro_torch.kernels import rotate_rescale as RR
from repro_torch.kernels import update_chain as UC
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm import LM
from repro_torch.optimizers.kfac import KFACEngine
from test_torch_whisper_parity import _close, _close_tree, _np

torch.set_num_threads(1)

N = 256


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Both packages' reduced LMs (no weights), gemma2's with
    ``max_factor_dim`` 64."""
    mfd = 64 if arch == "gemma2-2b" else 8192
    return {"jl": JLM(j_reduced(arch), JKFACConfig(max_factor_dim=mfd)),
            "lm": LM(get_reduced_config(arch), KFACConfig(max_factor_dim=mfd),
                     device="cpu"),
            "mfd": mfd}


# (arch, layer): every layout of the LMs' layers
LAYERS = [("smollm-135m", "blk0.attn.q"), ("smollm-135m", "blk0.attn.k"),
          ("smollm-135m", "blk0.attn.v"), ("smollm-135m", "blk0.attn.o"),
          ("smollm-135m", "blk0.mlp.down"), ("smollm-135m", "embed"),
          ("gemma2-2b", "blk0.mlp.gate"), ("gemma2-2b", "blk0.mlp.down"),
          ("whisper-small", "lm_head")]


def _metas(arch, layer):
    s = _setup(arch)
    return s["jl"].metas[layer], s["lm"].metas[layer]


def _side(seed, d, kind, nb, lead):
    """One factor side as numpy: a PSD (d, d) stack, nb PSD (db, db)
    blocks, or a non-negative diagonal (one entry zero), its spectrum over
    two decades."""
    rng = np.random.default_rng(seed)
    if kind == "diag":
        w = rng.random(lead + (d,)) * np.logspace(0, -2, d)
        w[..., 0] = 0.0
        return w.astype(np.float32)
    db = d // nb
    x = rng.standard_normal(lead + (nb, N, db)) * np.logspace(0, -1, db)
    f = np.einsum("...ni,...nj->...ij", x, x) / N
    return (f if kind == "block" else f[..., 0, :, :]).astype(np.float32)


def _factors(meta, seed=0):
    lead = (meta.n_stack,) if meta.n_stack else ()
    return {"a": _side(seed, meta.a_dim, meta.a_kind, meta.a_blocks, lead),
            "g": _side(seed + 1, meta.g_dim, meta.g_kind, meta.g_blocks,
                       lead)}


def _v(meta, seed=2):
    lead = (meta.n_stack,) if meta.n_stack else ()
    return np.random.default_rng(seed).standard_normal(
        lead + (meta.a_dim, meta.g_dim)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _tt(tree):
    return {k: _t(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# core/inverse: the eigen functions on every layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,nb", [("full", 1), ("block", 3), ("diag", 1)])
def test_eigh_basis_on_each_layout(kind, nb):
    arr = _side(5, 48, kind, nb, (2,))
    jq, jw = jinverse.eigh_basis(jnp.asarray(arr), kind)
    q, w = inverse.eigh_basis(_t(arr), kind)
    _close(w, np.asarray(jw), rtol=1e-4)
    assert w.shape == (2, 48)
    if kind == "diag":
        assert q is None and jq is None
        _close(w, np.maximum(arr, 0.0))
        return
    assert q.shape == arr.shape == jq.shape
    wb = w.reshape(*arr.shape[:-1])
    rebuilt = (q * wb[..., None, :]) @ q.transpose(-1, -2)
    _close(rebuilt, 0.5 * (arr + np.swapaxes(arr, -1, -2)))


@pytest.mark.parametrize("arch,layer", LAYERS)
def test_eigen_pair_state_on_lm_layouts(arch, layer):
    """Right after a refresh: ``s`` and ``damp`` (eigenvalues: basis-
    invariant) and the apply of a fixed V, each package from its own
    eigendecomposition; a diag side has no basis in either."""
    jmeta, meta = _metas(arch, layer)
    fac = _factors(meta)
    gamma = np.float32(0.37)
    want = _np(jinverse.eigen_pair_state(jmeta, fac["a"], fac["g"], gamma))
    got = inverse.eigen_pair_state(meta, _t(fac["a"]), _t(fac["g"]),
                                   torch.tensor(gamma))
    for k in ("qa", "qg"):
        assert (got[k] is None) == (want[k] is None), k
        if got[k] is not None:
            assert tuple(got[k].shape) == want[k].shape
    _close(got["s"], want["s"], rtol=1e-4)
    _close(got["damp"], want["damp"], rtol=1e-4)
    v = _v(meta)
    _close(inverse.apply_eigen(meta, got, _t(v)),
           np.asarray(jinverse.apply_eigen(jmeta, want, v)), rtol=1e-4)


@pytest.mark.parametrize("arch,layer", [("smollm-135m", "blk0.mlp.down"),
                                        ("gemma2-2b", "blk0.mlp.gate"),
                                        ("smollm-135m", "embed")])
def test_eigen_pair_multi_damp(arch, layer):
    """The γ sweep's candidates from one eigh: a (3, …) ``damp`` in front
    of the stack dims; the bases and ``s`` are views of one."""
    jmeta, meta = _metas(arch, layer)
    fac = _factors(meta, seed=7)
    gammas = np.array([0.37, 0.2, 0.6], np.float32)
    want = _np(jinverse.eigen_pair_multi(jmeta, fac["a"], fac["g"],
                                         jnp.asarray(gammas)))
    got = inverse.eigen_pair_multi(meta, _t(fac["a"]), _t(fac["g"]),
                                   _t(gammas))
    for k in want:
        assert (got[k] is None) == (want[k] is None), k
        if got[k] is not None:
            assert tuple(got[k].shape) == want[k].shape, k
    assert got["damp"].shape[0] == 3
    _close(got["damp"], want["damp"], rtol=1e-4)
    _close(got["s"], want["s"], rtol=1e-4)
    for c in range(3):
        one = inverse.eigen_pair_state(meta, _t(fac["a"]), _t(fac["g"]),
                                       _t(gammas[c]))
        for k in ("s", "damp"):
            assert torch.equal(got[k][c], one[k]), (c, k)


@pytest.mark.parametrize("arch,layer", LAYERS)
def test_rotate_apply_and_rescale_from_jax_bases(arch, layer):
    """JAX's eigen state carried across: both rotations, the apply and the
    per-step rescale at 1e-5."""
    jmeta, meta = _metas(arch, layer)
    fac = _factors(meta, seed=11)
    eig = _np(jinverse.eigen_pair_state(jmeta, fac["a"], fac["g"],
                                        np.float32(0.2)))
    v = _v(meta, seed=12)
    for adjoint in (True, False):
        _close(inverse.rotate_eigen(meta, _t(eig["qa"]), _t(eig["qg"]),
                                    _t(v), adjoint=adjoint),
               np.asarray(jinverse.rotate_eigen(jmeta, eig["qa"],
                                                eig["qg"], v,
                                                adjoint=adjoint)))
    _close(inverse.apply_eigen(meta, _tt(eig), _t(v)),
           np.asarray(jinverse.apply_eigen(jmeta, eig, v)))
    eps = np.float32(0.95)
    want = _np(jinverse.eigen_rescale(jmeta, eig, v, eps))
    _close_tree(inverse.eigen_rescale(meta, _tt(eig), _t(v),
                                      torch.tensor(eps)), want)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b",
                                  "whisper-small"])
def test_eigen_identity_is_jaxs(arch):
    """``init`` in eigen mode: every block's identity state has JAX's keys,
    Nones, shapes and values; the bases and diagonals are views (the
    stacked ones of one identity or one scalar)."""
    s = _setup(arch)
    cfg = dict(lambda_init=10.0, t3=5, inv_mode="eigen")
    jeng = JEngine(s["jl"], JKFACConfig(**cfg, max_factor_dim=s["mfd"]))
    eng = KFACEngine(s["lm"], KFACConfig(**cfg), device="cpu")
    for name, blk in eng.blocks.items():
        got, want = blk.eigen_identity(), _np(jeng.blocks[name]
                                              .eigen_identity())
        assert set(got) == set(want) == {"qa", "qg", "s", "damp"}
        _close_tree(got, want)
        if blk.meta.n_stack:
            assert got["s"].stride(0) == 0 and got["damp"].stride(0) == 0


@pytest.mark.parametrize("arch,layer", [("smollm-135m", "blk0.attn.k"),
                                        ("gemma2-2b", "blk0.mlp.gate"),
                                        ("gemma2-2b", "blk0.mlp.down"),
                                        ("whisper-small", "lm_head")])
@pytest.mark.parametrize("gamma", [1.0 / 64, 0.25])
def test_eigen_apply_matches_eigh_inverse_apply(arch, layer, gamma):
    """Right after a refresh the eigen apply is the damped eigh inverse
    apply, within 5e-6·κ (κ: the condition number of the damped
    Kronecker diagonal ``s + damp``)."""
    jmeta, meta = _metas(arch, layer)
    fac = _factors(meta, seed=13)
    v = _v(meta, seed=14)
    inv = jinverse.damped_pair_inverse(jmeta, fac["a"], fac["g"],
                                       np.float32(gamma), method="eigh")
    want = np.asarray(jinverse.apply_block_inverse(jmeta, inv, v))
    eig = inverse.eigen_pair_state(meta, _t(fac["a"]), _t(fac["g"]),
                                   torch.tensor(gamma, dtype=torch.float32))
    sd = (eig["s"] + eig["damp"]).numpy()
    kappa = float(sd.max() / sd.min())
    _close(inverse.apply_eigen(meta, eig, _t(v)), want, rtol=5e-6 * kappa)


# ---------------------------------------------------------------------------
# the blocks' eigen applies and chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layer", [("smollm-135m", "blk0.mlp.down"),
                                        ("smollm-135m", "blk0.attn.k"),
                                        ("gemma2-2b", "blk0.mlp.gate"),
                                        ("gemma2-2b", "blk0.mlp.down")])
@pytest.mark.parametrize("inv_mode", ["eigen", "blkdiag"])
def test_block_eigen_apply_and_chain(arch, layer, inv_mode):
    """The port's block (``DenseKronecker``: the batched ``rotate_rescale``
    and chain; ``BlockDiagKronecker``: matmul with the blocks in the
    batch) against the reference's block on the same state: the apply,
    and the chain's D and ΣD²."""
    jmeta, meta = _metas(arch, layer)
    kc = dict(inv_mode=inv_mode, use_rescale=False)
    blk = B.resolve(meta)(meta, KFACConfig(**kc), "cpu")
    jblk = jbase.resolve(jmeta)(jmeta, JKFACConfig(**kc))
    assert type(blk).__name__ == type(jblk).__name__
    fac = _factors(meta, seed=21)
    gamma = np.float32(0.3)
    eigen = inv_mode == "eigen"
    if eigen:
        st = _np(jinverse.eigen_pair_state(jmeta, fac["a"], fac["g"], gamma))
        _close(blk.precondition_eigen(_tt(st), _t(_v(meta))),
               np.asarray(jblk.precondition_eigen(st, _v(meta))))
    else:
        st = _np(jinverse.damped_pair_inverse(jmeta, fac["a"], fac["g"],
                                              gamma, method="eigh"))
    mom = _v(meta, seed=22)
    d, sq = blk.precond_momentum(_tt(st), _t(_v(meta)), _t(mom),
                                 torch.tensor(-0.05), torch.tensor(0.9),
                                 eigen=eigen)
    jd, jsq = jblk.precond_momentum(st, _v(meta), mom, np.float32(-0.05),
                                    np.float32(0.9), eigen=eigen)
    _close(d, np.asarray(jd))
    _close(sq, np.asarray(jsq))


# ---------------------------------------------------------------------------
# the batched plain kernel versions against the interpret-mode kernels
# ---------------------------------------------------------------------------

def _orth(seed, s, d):
    rng = np.random.default_rng(seed)
    return np.stack([np.linalg.qr(rng.standard_normal((d, d)))[0]
                     for _ in range(s)]).astype(np.float32)


def test_batched_rotate_rescale_ref_matches_vmapped_kernel():
    """(2, 256, 128): the stacked shape the reference's kernel tiles, which
    it vmaps over the stack dim (``repro/core/blocks/kron.py``)."""
    s_, a, g = 2, 256, 128
    rng = np.random.default_rng(30)
    qa, qg = _orth(31, s_, a), _orth(32, s_, g)
    v = rng.standard_normal((s_, a, g)).astype(np.float32)
    sd = (rng.random((s_, a, g)) + 0.05).astype(np.float32)
    want = np.asarray(jax.vmap(lambda *o: j_rotate_rescale(
        *o, lam=1e-12, interpret=True))(qa, v, qg, sd))
    got = RR.rotate_rescale_ref(_t(qa), _t(v), _t(qg), _t(sd), 1e-12)
    _close(got, want)


def test_batched_precond_momentum_ref_matches_kernel_and_composition():
    """The batched chain's plain version: D slice by slice against JAX's
    interpret-mode kernel at (256, 128) and ΣD² as the slices' sum; and
    against the reference's base-class composition, which is where it
    sends a stacked layer."""
    s_, a, g = 2, 256, 128
    rng = np.random.default_rng(40)
    a_inv = (rng.standard_normal((s_, a, a)) / a).astype(np.float32)
    g_inv = (rng.standard_normal((s_, g, g)) / g).astype(np.float32)
    v = rng.standard_normal((s_, a, g)).astype(np.float32)
    mom = rng.standard_normal((s_, a, g)).astype(np.float32)
    al, mu = np.float32(-0.02), np.float32(0.9)
    d, sq = UC.precond_momentum_ref(_t(a_inv), _t(v), _t(g_inv), _t(mom),
                                    alpha=torch.tensor(al),
                                    mu=torch.tensor(mu))
    sqs = []
    for i in range(s_):
        jd, jsq = j_precond_momentum(a_inv[i], v[i], g_inv[i], mom[i],
                                     alpha=al, mu=mu, interpret=True)
        _close(d[i], np.asarray(jd))
        sqs.append(float(jsq))
    assert float(sq) == pytest.approx(sum(sqs), rel=1e-5)
    jmeta, _ = _metas("smollm-135m", "blk0.mlp.down")
    jmeta = dataclasses.replace(jmeta, d_in=a, d_out=g, n_stack=s_)
    jblk = jbase.resolve(jmeta)(jmeta, JKFACConfig())
    jd, jsq = jblk.precond_momentum({"a_inv": a_inv, "g_inv": g_inv}, v,
                                    mom, al, mu)
    _close(d, np.asarray(jd))
    _close(sq, np.asarray(jsq))


# ---------------------------------------------------------------------------
# the wrappers' calls, which on the card are the launches
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counting(monkeypatch):
    """Count the calls of each wrapper where the blocks and the fused
    contractions call it; the card adds the launches the composite
    wrappers make inside (``precondition``, ``ns_step``: two matmul;
    ``rotate_rescale``: three matmul and a matmul_rescale;
    ``precond_momentum``: a matmul and an axpy_momentum)."""
    from repro_torch.core import fused
    from repro_torch.core.blocks import conv
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapper

    for mod, attr, name in ((kron, "factor_update", "factor_update"),
                            (fused, "factor_update", "factor_update"),
                            (conv, "patch_factor_update", "patch_factor"),
                            (fused, "patch_factor_update", "patch_factor"),
                            (kron, "precond_kernel", "precondition"),
                            (kron, "matmul", "matmul"),
                            (kron, "rotate_rescale", "rotate_rescale"),
                            (kron, "chain_kernel", "precond_momentum"),
                            (inverse.NS, "ns_step", "ns_step")):
        monkeypatch.setattr(mod, attr, counted(name, getattr(mod, attr)))

    def card():
        out = dict(calls)
        out["matmul"] = (calls.get("matmul", 0)
                         + 2 * calls.get("precondition", 0)
                         + 2 * calls.get("ns_step", 0)
                         + 3 * calls.get("rotate_rescale", 0)
                         + calls.get("precond_momentum", 0))
        for inner, outer in (("matmul_rescale", "rotate_rescale"),
                             ("axpy_momentum", "precond_momentum")):
            out[inner] = calls.get(outer, 0)
        return {k: n for k, n in out.items() if n}

    return card


# (arch, max_factor_dim, KFACConfig fields, steps)
LAUNCH_RUNS = {"smollm_eigen": ("smollm-135m", 8192,
                                dict(inv_mode="eigen"), 21),
               "smollm_chain": ("smollm-135m", 8192,
                                dict(use_rescale=False), 21),
               "gemma2_64_eigen": ("gemma2-2b", 64, dict(inv_mode="eigen"),
                                   6),
               "gemma2_64_eigen_chain": ("gemma2-2b", 64,
                                         dict(inv_mode="eigen",
                                              use_rescale=False), 6),
               "whisper_eigen_fs": ("whisper-small", 8192,
                                    dict(inv_mode="eigen",
                                         fused_stats=True), 6),
               "whisper_blkdiag_fs": ("whisper-small", 8192,
                                      dict(fused_stats=True), 6)}


@pytest.mark.parametrize("run", sorted(LAUNCH_RUNS))
def test_launcher_calls_each_wrapper_as_the_card_counts(run, monkeypatch):
    """The launcher's reduced runs on each new path (through the γ sweep
    at step 20 on smollm): the wrappers' calls, counted as the card counts
    its launches, equal ``chip_smoke.py::lm_launches`` from the metas."""
    arch, mfd, kw, steps = LAUNCH_RUNS[run]
    monkeypatch.setattr(tlaunch, "KFACConfig", functools.partial(
        KFACConfig, max_factor_dim=mfd))
    card = _counting(monkeypatch)
    res = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", str(steps)], log=lambda *_: None,
                       kfac_kw=kw)
    assert all(math.isfinite(h["loss"]) for h in res["history"])
    cs = _chip_smoke()
    kcfg = KFACConfig(lambda_init=10.0, t3=5, max_factor_dim=mfd, **kw)
    metas = LM(get_reduced_config(arch), kcfg, device="cpu").metas
    want = cs.lm_launches(kcfg, metas, steps)
    assert card() == {k: n for k, n in want.items() if n}
