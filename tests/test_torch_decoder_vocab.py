"""Reduced llama3.2-1b's layers (2 layers, d 64, 4 query heads over 2 KV
heads, d_ff 128) at the full vocab of 128,256, its tied head included,
trained by the port's ``Trainer.fit`` against a live JAX ``Trainer.fit``
on the CPU: the launcher's K-FAC setup (lambda_init 10, T3 5, blkdiag
with Newton–Schulz inverses) for 5 steps (the warmup refreshes, a plain
step and the lambda step at 4) on 2 sequences of 32 tokens, from JAX's
weights and uniforms.  At this vocab the embedding's Ā is a diagonal of
token counts that are zero for all but at most 64 of its entries, which
no reduced config reaches.  Held to ROADMAP queue C's free-running
bands (lambda and gamma exactly; the loss, alpha, mu and rho within 1e-3
through step 4, which is every step here).
"""
import dataclasses

import jax
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs import get_reduced_config as j_reduced
from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import SyntheticLMData as JLMData
from repro.models.lm import LM as JLM
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.lm import LM
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer
from test_torch_whisper_parity import _head_uniforms, _np

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
BATCH, SEQ, STEPS = 2, 32, 5


def test_full_vocab_trajectory_matches_live_jax():
    vocab = get_config(ARCH).vocab_size
    jcfg = dataclasses.replace(j_reduced(ARCH), vocab_size=vocab)
    jl = JLM(jcfg)
    jp = jl.init_params(jax.random.PRNGKey(0))
    want = JTrainer(jl, joptimizers.kfac(jl, JKFACConfig(lambda_init=10.0,
                                                         t3=5)),
                    JTrainConfig(steps=STEPS, seed=0, log_every=10_000),
                    None, None).fit(jp, JLMData(vocab, SEQ, BATCH),
                                    steps=STEPS,
                                    log=lambda *_: None)["history"]
    cfg = get_reduced_config(ARCH).replace(vocab_size=vocab)
    lm = LM(cfg, device="cpu")
    assert lm.metas["embed"].a_kind == "diag" and "lm_head" not in lm.metas
    got = Trainer(lm, kfac(lm, KFACConfig(lambda_init=10.0, t3=5),
                           device="cpu"),
                  TrainConfig(steps=STEPS, seed=0, log_every=10_000),
                  noise=lambda step, shape: _head_uniforms(0, step, shape),
                  device="cpu").fit(
        lm_params_from_numpy(_np(jp), "cpu"),
        SyntheticLMData(vocab, SEQ, BATCH, device="cpu"), steps=STEPS,
        log=lambda *_: None)["history"]
    assert len(got) == len(want) == STEPS
    for step in range(STEPS):
        for k in ("loss", "lam", "gamma", "alpha", "mu", "rho"):
            assert (k in got[step]) == (k in want[step]), (step, k)
        for k in ("lam", "gamma"):
            assert got[step][k] == pytest.approx(want[step][k], rel=1e-6)
        for k in ("loss", "alpha", "mu", "rho"):   # every step is <= 4
            if k in want[step]:
                assert got[step][k] == pytest.approx(want[step][k],
                                                     rel=1e-3), (step, k)
