"""The port's checkpoints, resume, preemption and curvature bundles on the
CPU, the port alone (``repro_torch/training/checkpoint.py``,
``repro_torch/curvature/bundle.py``, ``Trainer.fit``, ``launch/train.py
--ckpt_dir``).

Counterparts of the reference's ``tests/test_training.py`` checkpoint
tests (round trip with ``keep``, the schema 1/2/3 migrations, schema 5
refused, a torn write ignored, the trainer's restart) and of
``tests/test_curvature.py``'s trainer export tests, plus what the port
adds: the flat keys of every state kind, restore onto another device,
SIGTERM preemption with the previous handler put back, the bundle's
snapshot never written in place, and first-order runs that resume bitwise
(they have no warmup to re-arm).  Everything here is exact: the CPU runs
the same operations in the same order.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import optimizers
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.core.transform import KFACState, TransformState
from repro_torch.curvature import (CurvatureBundle, load_bundle, save_bundle,
                                   snapshot_bundle)
from repro_torch.curvature.bundle import BundleWriter
from repro_torch.data.pipeline import SyntheticAutoencoderData
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm import LM
from repro_torch.models.mlp import MLP
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.checkpoint import SCHEMA_VERSION, Checkpointer
from repro_torch.training.trainer import Trainer
from repro_torch.utils.tree import flatten_with_keys, unflatten_with_keys

torch.set_num_threads(1)

PKG_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _equal_tree(got, want):
    """Bitwise equality of two trees (tensors or numpy arrays)."""
    g, w = flatten_with_keys(got), flatten_with_keys(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for k in w:
        a = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
        b = w[k].numpy() if isinstance(w[k], torch.Tensor) else w[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _problem(dims=(16, 8, 16), n=64, seed=1):
    mlp = MLP(list(dims), device="cpu")
    params = mlp.init_params(torch.Generator().manual_seed(0))

    class Data:
        src = SyntheticAutoencoderData(dims[0], 4, n, seed=seed,
                                       device="cpu")

        def batch(self, step):
            return self.src.batch(step)

    return mlp, params, Data()


def _kfac(mlp, **kw):
    cfg = dict(lambda_init=1.0, t3=2, t1=2, t2=6)
    cfg.update(kw)
    return kfac(mlp, KFACConfig(**cfg), family="bernoulli", device="cpu")


def _one_step_state(**kw):
    mlp, params, data = _problem()
    opt = _kfac(mlp, **kw)
    state = opt.init(params, data.batch(0))
    params, state, _ = opt.update(None, state, params, data.batch(0),
                                  lambda shape: torch.rand(
                                      shape, generator=torch.Generator()
                                      .manual_seed(1)))
    return mlp, params, data, opt, state


# ---------------------------------------------------------------------------
# flat keys
# ---------------------------------------------------------------------------

def test_flatten_with_keys_follows_the_reference_paths():
    """Dict keys, dataclass fields and sequence indices joined by "::";
    None gives no leaf; an empty tuple gives no leaf but takes its index
    (SGD's chain state ``((), velocity)``)."""
    t = torch.zeros
    sgd = TransformState(step=t((), dtype=torch.int32),
                         inner=((), {"W0": t(2), "W1": t(3)}))
    assert sorted(flatten_with_keys({"state": sgd})) == [
        "state::inner::1::W0", "state::inner::1::W1", "state::step"]
    adam = TransformState(step=t((), dtype=torch.int32), inner=(
        {"mu": {"W0": t(2)}, "nu": {"W0": t(2)},
         "count": t((), dtype=torch.int32)}, ()))
    assert sorted(flatten_with_keys({"state": adam})) == [
        "state::inner::0::count", "state::inner::0::mu::W0",
        "state::inner::0::nu::W0", "state::step"]
    tree = {"b": [t(1), None, {"c": t(1)}], "a": (None, (), t(1))}
    assert list(flatten_with_keys(tree)) == ["a::2", "b::0", "b::2::c"]


def test_unflatten_with_keys_fills_the_template():
    _, params, _, _, state = _one_step_state()
    tree = {"params": params, "state": state}
    flat = flatten_with_keys(tree)
    back = unflatten_with_keys(tree, {k: v.numpy() for k, v in flat.items()},
                               lambda tmpl, v: torch.from_numpy(v))
    assert isinstance(back["state"], KFACState)
    assert back["state"].inv_pending is None
    _equal_tree(back, tree)
    flat.pop("state::lam")
    with pytest.raises(KeyError, match="lam"):
        unflatten_with_keys(tree, flat)
    kept = unflatten_with_keys(tree, flat, defaultable=("lam",))
    assert kept["state"].lam is state.lam


# ---------------------------------------------------------------------------
# Checkpointer (tests/test_training.py's counterparts)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor(3.5), "d": (torch.ones(4),
                                                torch.zeros(2))}}
    ck.save(5, tree, block=True)
    ck.save(9, {"a": tree["a"] * 2.0, "b": tree["b"]}, block=True)
    assert ck.all_steps() == [5, 9]
    step, got = ck.restore(tree)
    assert step == 9
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"].numpy() * 2)
    assert isinstance(got["b"]["d"], tuple)
    # keep=2 gc
    ck.save(11, tree, block=True)
    ck.save(12, tree, block=True)
    assert ck.all_steps() == [11, 12]
    man = json.loads((tmp_path / "step_00000012" / "manifest.json")
                     .read_text())
    assert man["schema"] == SCHEMA_VERSION == 4
    assert man["keys"] == ["a", "b::c", "b::d::0", "b::d::1"]
    assert ck.stats["bytes"] == 4 * (6 + 1 + 4 + 2)


def test_checkpoint_async_save_copies_at_save_time(tmp_path):
    """The copy to host is taken by ``save``; only the write runs on the
    thread, so a tensor changed after ``save`` returns is written as it
    was."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    x = torch.ones(1000)
    ck.save(1, {"x": x})
    x.mul_(3.0)
    ck.wait()
    _, got = ck.restore({"x": x})
    assert torch.equal(got["x"], torch.ones(1000))
    assert ck.stats["write_s"] > 0 and ck.stats["save_host_ms"] > 0


def test_checkpoint_dict_state_migration(tmp_path):
    """Schema 1: a checkpoint of the pre-dataclass *dict* state restores
    into the ``KFACState`` template unchanged; a schema above 4 raises."""
    _, params, _, _, state = _one_step_state()
    old_dict = {f.name: getattr(state, f.name)
                for f in dataclasses.fields(state)}
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, {"params": params, "state": old_dict}, block=True)
    man_path = tmp_path / "step_00000003" / "manifest.json"
    man = json.loads(man_path.read_text())
    assert man["schema"] == 4
    del man["schema"]
    man_path.write_text(json.dumps(man))

    step, got = ck.restore({"params": params, "state": state})
    assert step == 3
    assert isinstance(got["state"], KFACState)
    _equal_tree(got, {"params": params, "state": state})

    man["schema"] = 99
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="schema"):
        ck.restore({"params": params, "state": state})


def test_checkpoint_v2_state_migration(tmp_path):
    """Schema 2: no ``staleness`` leaf; restoring keeps the template's
    value for it and the checkpoint's for everything else, and a missing
    leaf of another field still raises ``KeyError``."""
    mlp, params, data, opt, state = _one_step_state()
    state = state.replace(staleness=torch.tensor(2, dtype=torch.int32))
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(4, {"params": params, "state": state}, block=True)
    step_dir = tmp_path / "step_00000004"
    with np.load(step_dir / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files
                if "staleness" not in k.split("::")}
    assert len(flat) == len(flatten_with_keys(
        {"params": params, "state": state})) - 1
    np.savez(step_dir / "arrays.npz", **flat)
    man = json.loads((step_dir / "manifest.json").read_text())
    man["schema"] = 2
    (step_dir / "manifest.json").write_text(json.dumps(man))

    template = opt.init(params, data.batch(0))
    step, got = ck.restore({"params": params, "state": template})
    assert step == 4
    assert int(got["state"].staleness) == 0
    assert got["state"].inv_pending is None
    assert torch.equal(got["state"].lam, state.lam)
    _equal_tree(got["state"].factors, state.factors)

    with np.load(step_dir / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files if "::lam" not in k}
    np.savez(step_dir / "arrays.npz", **flat)
    with pytest.raises(KeyError, match="lam"):
        ck.restore({"params": params, "state": template})


def test_checkpoint_v3_state_migration(tmp_path):
    """Schema 3 -> 4 is manifest-only: a v3 checkpoint restores verbatim
    and has no bundle; a pointer at a torn bundle reports None; schema 5 is
    refused."""
    mlp, params, data, opt, state = _one_step_state()
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(6, {"params": params, "state": state}, block=True)
    man_path = tmp_path / "step_00000006" / "manifest.json"
    man = json.loads(man_path.read_text())
    man["schema"] = 3
    man.pop("curvature_bundle", None)
    man_path.write_text(json.dumps(man))

    template = opt.init(params, data.batch(0))
    step, got = ck.restore({"params": params, "state": template})
    assert step == 6
    assert ck.bundle_path(6) is None
    _equal_tree(got["state"], state)

    man["schema"] = 4
    man["curvature_bundle"] = "curvature/step_00000006"
    man_path.write_text(json.dumps(man))
    assert ck.bundle_path(6) is None
    (tmp_path / "curvature" / "step_00000006").mkdir(parents=True)
    assert ck.bundle_path(6) is None
    (tmp_path / "curvature" / "step_00000006" / "COMMIT").write_text("ok")
    assert ck.bundle_path(6) == str(tmp_path / "curvature/step_00000006")

    man["schema"] = 5
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="schema"):
        ck.restore({"params": params, "state": template})


def test_checkpoint_torn_write_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, {"x": torch.ones(2)}, block=True)
    torn = tmp_path / "step_00000007"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"garbage")
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ck.latest_step() == 3
    assert ck.restore({"x": torch.zeros(2)})[0] == 3


def test_gc_drops_the_step_bundle_with_the_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1, async_save=False)
    for step in (2, 4):
        b = tmp_path / "curvature" / f"step_{step:08d}"
        b.mkdir(parents=True)
        (b / "COMMIT").write_text("ok")
        ck.save(step, {"x": torch.ones(1)}, block=True,
                curvature_bundle=f"curvature/step_{step:08d}")
    assert ck.all_steps() == [4]
    assert not (tmp_path / "curvature" / "step_00000002").exists()
    assert ck.bundle_path() == str(tmp_path / "curvature" / "step_00000004")


def test_restore_onto_another_device(tmp_path):
    """``device=`` places every leaf there, the template's values kept by
    a migration too (the card-to-CPU direction is a card test)."""
    _, params, _, _, state = _one_step_state()
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"params": params, "state": state}, block=True)
    step, got = ck.restore({"params": params, "state": state},
                           device="cpu")
    assert all(x.device.type == "cpu"
               for x in flatten_with_keys(got).values())
    _equal_tree(got, {"params": params, "state": state})
    assert "restore_read_s" in ck.stats and "restore_device_s" in ck.stats


def test_trainer_end_to_end_and_restart(tmp_path):
    mlp, params, data = _problem()
    tcfg = TrainConfig(steps=8, checkpoint_every=4, log_every=100)
    ck = Checkpointer(str(tmp_path), async_save=False)
    out = Trainer(mlp, _kfac(mlp), tcfg, device="cpu",
                  checkpointer=ck).fit(params, data, steps=8)
    assert len(out["history"]) == 8
    assert out["history"][-1]["loss"] < out["history"][0]["loss"] + 1e-3
    assert ck.latest_step() == 8
    logs = []
    out2 = Trainer(mlp, _kfac(mlp), tcfg, device="cpu",
                   checkpointer=ck).fit(params, data, steps=10,
                                        log=logs.append)
    assert len(out2["history"]) == 2      # only steps 8..9
    assert "[trainer] restored checkpoint at step 8" in logs
    assert int(out2["state"].step) == 10


# ---------------------------------------------------------------------------
# resume: K-FAC re-arms its warmup, first-order runs resume bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inv_mode", ["blkdiag", "tridiag"])
def test_resumed_kfac_rearms_the_warmup(tmp_path, inv_mode):
    """As in the reference: a run resumed at step 4 starts from the same
    parameters (its first loss is the uninterrupted run's, bitwise) and
    refreshes at steps 4, 5 and 6, where the uninterrupted one refreshes
    at 5 only (T3 5), so it departs at its first update.  tridiag's Ψ/Σ
    cache is written but restored as None (its template holds None) and
    rebuilt by the re-armed refresh."""
    mlp, params, data = _problem((16, 8, 4, 8, 16))
    kw = dict(inv_mode=inv_mode, inverse_method="eigh", t3=5, t1=5, t2=20)
    tcfg = TrainConfig(steps=8, checkpoint_every=4, log_every=100)
    full = Trainer(mlp, _kfac(mlp, **kw), tcfg, device="cpu").fit(
        params, data, steps=8, log=lambda *_: None)["history"]
    ck = Checkpointer(str(tmp_path), async_save=False)
    Trainer(mlp, _kfac(mlp, **kw), tcfg, device="cpu",
            checkpointer=ck).fit(params, data, steps=4, log=lambda *_: None)
    with np.load(tmp_path / "step_00000004" / "arrays.npz") as z:
        tri = [k for k in z.files if "::__tri__::" in k]
    assert bool(tri) == (inv_mode == "tridiag")
    opt = _kfac(mlp, **kw)
    refreshed = []
    eng = opt.engine
    eng.refresh_inverses = (lambda state, hot=False, _f=eng.refresh_inverses:
                            refreshed.append(int(state.step))
                            or _f(state, hot))
    tr = Trainer(mlp, opt, tcfg, device="cpu", checkpointer=ck)
    template = opt.init(params, data.batch(0))
    _, got = ck.restore({"params": params, "state": template})
    if inv_mode == "tridiag":
        assert got["state"].inv["__tri__"] is None
    resumed = tr.fit(params, data, steps=8, log=lambda *_: None)["history"]
    assert refreshed == [4, 5, 6]
    assert resumed[0]["loss"] == full[4]["loss"]
    assert resumed[1]["loss"] != full[5]["loss"]
    assert all(np.isfinite(h["loss"]) for h in resumed)


@pytest.mark.parametrize("name,kw", [("sgd_momentum", {"lr": 0.1}),
                                     ("adam", {"lr": 1e-2})])
def test_first_order_resume_is_bitwise(tmp_path, name, kw):
    """SGD and Adam have no warmup: a run checkpointed at step 4 and
    resumed to 8 is the uninterrupted run, bit for bit."""
    mlp, params, data = _problem((16, 12, 16))
    tcfg = TrainConfig(steps=8, checkpoint_every=4, log_every=100)
    full = Trainer(mlp, optimizers.get(name, mlp, **kw), tcfg,
                   device="cpu").fit(params, data, steps=8,
                                     log=lambda *_: None)
    ck = Checkpointer(str(tmp_path), async_save=True)
    first = Trainer(mlp, optimizers.get(name, mlp, **kw), tcfg,
                    device="cpu", checkpointer=ck).fit(
        params, data, steps=4, log=lambda *_: None)
    with np.load(tmp_path / "step_00000004" / "arrays.npz") as z:
        keys = set(z.files)
    assert ("state::inner::1::W0" in keys) == (name == "sgd_momentum")
    assert ("state::inner::0::count" in keys) == (name == "adam")
    second = Trainer(mlp, optimizers.get(name, mlp, **kw), tcfg,
                     device="cpu", checkpointer=ck).fit(
        params, data, steps=8, log=lambda *_: None)
    assert first["history"] + second["history"] == full["history"]
    _equal_tree(second["params"], full["params"])
    _equal_tree(second["state"], full["state"])


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

class _SigtermAt:
    """Data that sends this process SIGTERM while step ``at``'s batch is
    built."""

    def __init__(self, data, at):
        self.data, self.at = data, at

    def batch(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.data.batch(step)


def test_preemption_checkpoints_and_restores_the_handler(tmp_path):
    """SIGTERM during step 3: ``fit`` finishes step 3, makes a blocking
    checkpoint at step 4 and stops; the handler that was set before
    ``fit`` is set again after it, and a relaunch resumes at step 4."""
    mlp, params, data = _problem()
    seen = []
    before = lambda signum, frame: seen.append(signum)
    previous = signal.signal(signal.SIGTERM, before)
    try:
        ck = Checkpointer(str(tmp_path), async_save=True)
        tcfg = TrainConfig(steps=10, checkpoint_every=100, log_every=100)
        logs = []
        out = Trainer(mlp, _kfac(mlp), tcfg, device="cpu",
                      checkpointer=ck).fit(params, _SigtermAt(data, 3),
                                           steps=10, log=logs.append)
        assert len(out["history"]) == 4
        assert "[trainer] preempted at step 3; checkpointing" in logs
        assert ck.all_steps() == [4]
        assert (tmp_path / "step_00000004" / "COMMIT").exists()
        assert signal.getsignal(signal.SIGTERM) is before
        assert seen == []            # the trainer's handler took it
        out2 = Trainer(mlp, _kfac(mlp), tcfg, device="cpu",
                       checkpointer=ck).fit(params, data, steps=6,
                                            log=lambda *_: None)
        assert len(out2["history"]) == 2
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_handler_put_back_when_fit_raises(tmp_path):
    mlp, params, data = _problem()
    before = signal.getsignal(signal.SIGTERM)
    during = []

    class Broken:
        def batch(self, step):
            during.append(signal.getsignal(signal.SIGTERM))
            if step == 2:
                raise RuntimeError("no batch")
            return data.batch(step)

    with pytest.raises(RuntimeError, match="no batch"):
        Trainer(mlp, _kfac(mlp), TrainConfig(log_every=100), device="cpu",
                checkpointer=Checkpointer(str(tmp_path))).fit(
                    params, Broken(), steps=4, log=lambda *_: None)
    assert all(h is not before for h in during)     # the trainer's was set
    assert signal.getsignal(signal.SIGTERM) is before


def test_fit_without_checkpointer_leaves_sigterm_alone():
    """With nothing to save, ``fit`` sets no handler: a SIGTERM during
    the run reaches the handler that was set before, and the run is not
    cut short."""
    mlp, params, data = _problem()
    seen = []
    before = lambda signum, frame: seen.append(signum)
    previous = signal.signal(signal.SIGTERM, before)
    during = []

    class Watch:
        def batch(self, step):
            during.append(signal.getsignal(signal.SIGTERM))
            return _SigtermAt(data, 2).batch(step)

    try:
        out = Trainer(mlp, _kfac(mlp), TrainConfig(log_every=100),
                      device="cpu").fit(params, Watch(), steps=5,
                                        log=lambda *_: None)
        assert len(out["history"]) == 5
        assert seen == [signal.SIGTERM]
        assert all(h is before for h in during)
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, previous)


# ---------------------------------------------------------------------------
# curvature bundles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inv_mode", ["blkdiag", "eigen", "tridiag"])
def test_snapshot_is_not_written_in_place(tmp_path, inv_mode):
    """The snapshot keeps references to the state's tensors; after ``fit``
    has run 3 more steps from that very state, the written bundle still
    equals a host copy taken at snapshot time (no stage of the port writes
    a state tensor in place)."""
    mlp, params, data = _problem((16, 8, 4, 8, 16))
    opt = _kfac(mlp, inv_mode=inv_mode, inverse_method="eigh", t3=2)
    tcfg = TrainConfig(log_every=100)
    out = Trainer(mlp, opt, tcfg, device="cpu").fit(
        params, data, steps=4, log=lambda *_: None)
    bundle = snapshot_bundle(opt.engine, out["state"])
    at_snapshot = {name: {k: v.clone() for k, v in e.items()}
                   for name, e in bundle.eigen.items()}
    if inv_mode == "eigen":     # the live EKFAC state, by reference
        for name, e in bundle.eigen.items():
            assert e["s"] is out["state"].inv[name]["s"]
    resumed = dataclasses.replace(opt, init=lambda p, b: out["state"])
    more = Trainer(mlp, resumed, tcfg, device="cpu").fit(
        out["params"], data, steps=7, start_step=4, log=lambda *_: None)
    assert len(more["history"]) == 3
    writer = BundleWriter()
    writer.write_async(str(tmp_path / "b"), bundle)
    writer.wait()
    assert writer.write_s > 0
    back = load_bundle(str(tmp_path / "b"), device="cpu")
    _equal_tree(back.eigen, at_snapshot)
    assert back.step == 4 and set(back.metas) == set(opt.engine.blocks)


def test_bundle_roundtrip_and_bf16_bases(tmp_path):
    """float32 exactly; ``dtype="bfloat16"`` stores the bases as the
    bfloat16 rounding's bit pattern and reads back
    ``q.to(torch.bfloat16).float()``, s and damp float32."""
    mlp, params, data = _problem((16, 8, 4, 8, 16))
    opt = _kfac(mlp, inv_mode="eigen", inverse_method="eigh")
    out = Trainer(mlp, opt, TrainConfig(log_every=100), device="cpu").fit(
        params, data, steps=3, log=lambda *_: None)
    bundle = snapshot_bundle(opt.engine, out["state"])
    save_bundle(bundle, str(tmp_path / "f32"))
    back = load_bundle(str(tmp_path / "f32"), device="cpu")
    _equal_tree(back.eigen, bundle.eigen)
    assert back.metas == bundle.metas
    assert (back.lam, back.gamma, back.eta) == (bundle.lam, bundle.gamma,
                                               bundle.eta)
    save_bundle(bundle, str(tmp_path / "bf16"), dtype="bfloat16")
    with np.load(tmp_path / "bf16" / "arrays.npz") as z:
        assert z["eig::layer0::qa"].dtype == np.uint16
        assert z["eig::layer0::s"].dtype == np.float32
    half = load_bundle(str(tmp_path / "bf16"), device="cpu")
    for name, e in bundle.eigen.items():
        for k in ("qa", "qg"):
            assert torch.equal(half.eigen[name][k],
                               e[k].to(torch.bfloat16).float())
        for k in ("s", "damp"):
            assert torch.equal(half.eigen[name][k], e[k])
    with pytest.raises(ValueError, match="dtype"):
        save_bundle(bundle, str(tmp_path / "x"), dtype="float16")
    with pytest.raises(FileNotFoundError):
        load_bundle(str(tmp_path / "missing"), device="cpu")


def test_bundle_schema_above_one_is_refused(tmp_path):
    b = CurvatureBundle(step=1, lam=1.0, gamma=1.0, eta=0.0, metas={},
                        eigen={}, schema=2)
    save_bundle(b, str(tmp_path / "b"))
    with pytest.raises(ValueError, match="schema"):
        load_bundle(str(tmp_path / "b"), device="cpu")


def test_snapshot_of_first_order_and_lm(tmp_path):
    """No curvature blocks: None.  An LM gives a bundle: one eigen state
    per block, stacked over its layers, with no basis on a diagonal side
    (the embedding's Ā, the head's Ḡ), and its saved form loads back."""
    mlp, params, data = _problem()
    sgd = optimizers.get("sgd_momentum", mlp, lr=0.1)
    assert snapshot_bundle(sgd.engine, sgd.init(params, data.batch(0))) \
        is None
    cfg = get_reduced_config("whisper-small")
    lm = LM(cfg, device="cpu")
    opt = kfac(lm, KFACConfig(lambda_init=10.0, t3=5), device="cpu")
    lp = lm.init_params(torch.Generator().manual_seed(0))
    ldata = tlaunch._ArchData(cfg, tlaunch.SyntheticLMData(
        cfg.vocab_size, 16, 2, device="cpu"))
    state = opt.init(lp, ldata.batch(0))
    _, state, _ = opt.update(None, state, lp, ldata.batch(0),
                             lambda shape: torch.rand(shape))
    bundle = snapshot_bundle(opt.engine, state)
    assert set(bundle.eigen) == set(lm.metas)
    assert bundle.eigen["embed"]["qa"] is None
    assert bundle.eigen["lm_head"]["qg"] is None
    for name, m in lm.metas.items():
        lead = (m.n_stack,) if m.n_stack else ()
        assert tuple(bundle.eigen[name]["s"].shape) == (*lead, m.a_dim,
                                                        m.g_dim), name
    save_bundle(bundle, str(tmp_path / "b"))
    back = load_bundle(str(tmp_path / "b"), device="cpu")
    assert back.metas == bundle.metas
    for name in bundle.eigen:
        for k, v in bundle.eigen[name].items():
            assert (v is None) == (back.eigen[name][k] is None), (name, k)
            if v is not None:
                assert torch.equal(back.eigen[name][k], v), (name, k)


def _bundle_data():
    """tests/test_curvature.py's trainer-export setup: an 8-6-4 MLP and a
    fresh Bernoulli batch of 32 a step."""
    mlp = MLP([8, 6, 4], device="cpu")
    params = mlp.init_params(torch.Generator().manual_seed(0))

    class Data:
        def batch(self, step):
            g = torch.Generator().manual_seed(5 + step)
            x = (torch.rand(32, 8, generator=g) < 0.5).float()
            return {"x": x, "y": x[:, :4]}

    return mlp, params, Data()


def test_trainer_exports_checkpoint_adjacent_bundle(tmp_path):
    mlp, params, data = _bundle_data()
    opt = kfac(mlp, KFACConfig(inv_mode="eigen", lambda_init=2.0, t3=2),
               family="bernoulli", device="cpu")
    ck = Checkpointer(str(tmp_path), async_save=False)
    logs = []
    tr = Trainer(mlp, opt, TrainConfig(steps=6, checkpoint_every=3,
                                       curvature_every=3, log_every=100),
                 device="cpu", checkpointer=ck)
    out = tr.fit(params, data, steps=6, log=logs.append)
    assert ck.latest_step() == 6
    assert "[trainer] step 5: curvature bundle -> curvature/step_00000006" \
        in logs
    path = ck.bundle_path()
    assert path is not None and path.endswith("step_00000006")
    man = json.loads(open(os.path.join(
        ck.dir, "step_00000006", "manifest.json")).read())
    assert man["curvature_bundle"] == os.path.join("curvature",
                                                   "step_00000006")
    bundle = load_bundle(path, device="cpu")
    assert bundle.step == 6
    assert set(bundle.block_names) == set(opt.engine.blocks)
    _equal_tree(bundle.eigen, out["state"].inv)
    # ... and the checkpoint itself still restores (manifest-only change)
    step, got = ck.restore({"params": params,
                            "state": opt.init(params, data.batch(0))})
    assert step == 6


def test_trainer_without_curvature_every_exports_nothing(tmp_path):
    mlp, params, data = _bundle_data()
    opt = kfac(mlp, KFACConfig(lambda_init=2.0), family="bernoulli",
               device="cpu")
    ck = Checkpointer(str(tmp_path), async_save=False)
    Trainer(mlp, opt, TrainConfig(steps=4, checkpoint_every=2,
                                  log_every=100),
            device="cpu", checkpointer=ck).fit(params, data, steps=4,
                                               log=lambda *_: None)
    assert ck.latest_step() == 4
    assert ck.bundle_path() is None
    assert not (tmp_path / "curvature").exists()


def test_first_order_trainer_exports_no_bundle(tmp_path):
    mlp, params, data = _bundle_data()
    ck = Checkpointer(str(tmp_path), async_save=False)
    Trainer(mlp, optimizers.get("adam", mlp, lr=1e-2),
            TrainConfig(checkpoint_every=2, curvature_every=2,
                        log_every=100),
            device="cpu", checkpointer=ck).fit(params, data, steps=2,
                                               log=lambda *_: None)
    assert ck.latest_step() == 2 and ck.bundle_path() is None


# ---------------------------------------------------------------------------
# the launcher and the imports
# ---------------------------------------------------------------------------

def test_train_launcher_ckpt_dir(tmp_path):
    """``--ckpt_dir``: reduced whisper checkpoints at step 10
    (``max(10, steps // 2)``), and a relaunch with ``--steps 12`` resumes
    there and runs steps 10 and 11."""
    d = str(tmp_path / "ckpt")
    common = ["--arch", "whisper-small", "--reduced", "--device", "cpu",
              "--ckpt_dir", d]
    first = tlaunch.main(common + ["--steps", "10"], log=lambda *_: None)
    assert len(first["history"]) == 10
    assert Checkpointer(d).all_steps() == [10]
    logs = []
    second = tlaunch.main(common + ["--steps", "12"], log=logs.append)
    assert "[trainer] restored checkpoint at step 10" in logs
    assert len(second["history"]) == 2
    assert int(second["state"].step) == 12
    assert all(np.isfinite(h["loss"]) for h in second["history"])
    assert Checkpointer(d).all_steps() == [10]
    done = tlaunch.main(common + ["--steps", "10"], log=logs.append)
    assert done["history"] == [] and "no step left" in logs[-1]


def test_train_launcher_keeps_keep_checkpoints(tmp_path, monkeypatch):
    """The launcher's ``Checkpointer`` keeps ``TrainConfig.
    keep_checkpoints`` steps: at 1, a 20-step run checkpointed at 10 and
    20 keeps step 20 alone."""
    import functools
    monkeypatch.setattr(tlaunch, "TrainConfig",
                        functools.partial(TrainConfig, keep_checkpoints=1))
    d = str(tmp_path / "ckpt")
    out = tlaunch.main(["--arch", "whisper-small", "--reduced", "--device",
                        "cpu", "--ckpt_dir", d, "--steps", "20"],
                       log=lambda *_: None)
    assert len(out["history"]) == 20
    assert Checkpointer(d).all_steps() == [20]


def test_checkpoint_modules_import_without_jax_or_ml_dtypes():
    code = ("import sys\n"
            "import repro_torch.training.checkpoint\n"
            "import repro_torch.curvature\n"
            "import repro_torch.training.trainer\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "             ('jax', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=PKG_SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
