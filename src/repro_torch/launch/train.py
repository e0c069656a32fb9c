"""Training launcher (mirrors ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch llama3.2-1b --steps 6

trains a full-width arch with K-FAC on the card (``--device cuda``, the
default; ``--device cpu`` runs the plain PyTorch versions, e.g. with
``--reduced``).  ``--arch`` offers the dense decoders smollm-135m,
llama3.2-1b (the default, as the reference's) and gemma2-2b (sliding
window, both softcaps, and block-diagonal factors on its d_ff of 9216,
above ``KFACConfig.max_factor_dim``) and the encoder-decoder
whisper-small: the archs whose training is held against the reference.
The ``KFACConfig`` is built before the LM and given to it, as the
reference launcher does: it sets the metas' factor layouts.
``--optimizer sgd_momentum`` or ``adam`` trains with a first-order
baseline at ``--lr`` (default 1e-3) instead.  The reference launcher's
defaults: batch 8, seq 64, λ₀ 10, T3 5, ``--inv_mode blkdiag`` with
Newton–Schulz inverses.  ``--inv_mode tridiag`` runs the block-diagonal
path on an LM (it has no chain of layers), as the reference does;
``--inv_mode eigen`` runs EKFAC (eigh bases on the T3 schedule, the
eigenbasis diagonal re-estimated every step) on every arch.  The fused
fixed-lr chain (``use_rescale=False``) and ``fused_stats`` are
``KFACConfig`` fields with no option here, as in the reference.
``--refresh_mode staggered`` spreads the T3 inverse refresh over T3 steps
in cost-balanced groups, and ``--tau1`` (default 1.0) computes the factor
statistics on every round(1/τ1)-th sequence of the batch; the reference's
``sharded`` and ``overlap`` refresh modes wait for the distributed slice.
Weights are the port's own random initialization from seed 0; the tokens
and mel frames are the reference's synthetic streams, bitwise.
``--ckpt_dir DIR`` checkpoints into DIR every ``max(10, steps // 2)``
steps, as the reference does, and a relaunch with the same DIR resumes
from its latest checkpoint (``--steps`` is the step to stop at); without
it nothing is written.  The reference's ``--mesh`` and ``--obs*`` options
wait for their slices.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import optimizers
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLMData, make_audio_batch
from repro_torch.models.lm import LM
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.trainer import Trainer


TRAINED_ARCHS = ("llama3.2-1b", "smollm-135m", "gemma2-2b", "whisper-small")


class _ArchData:
    """Wraps the token stream with the arch's raw modality inputs (mel
    frames: the model's own conv stem embeds them)."""

    def __init__(self, cfg, base):
        self.cfg, self.base = cfg, base

    def batch(self, step):
        b = self.base.batch(step)
        if self.cfg.frontend == "audio":
            b = make_audio_batch(b, self.cfg.n_mels, 2 * self.cfg.encoder_seq,
                                 step)
        return b


def main(argv=None, log=print, wrap_opt=None, cfg=None, kfac_kw=None):
    """Parse ``argv`` and train.  ``wrap_opt``, given, maps the optimizer
    to the one the trainer calls (e.g. one that times its updates).
    ``cfg``, given, is the ``ModelConfig`` trained in place of the arch's
    (e.g. the arch cut in depth); its ``name`` must be the arch's.
    ``kfac_kw``, given, are ``KFACConfig`` fields set beside the options'
    (e.g. ``use_rescale=False`` for the fused fixed-lr chain,
    ``fused_stats=True``): the reference reaches them through its
    ``KFACConfig`` too, with no option of its launcher."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=TRAINED_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt_dir", default="")
    ap.add_argument("--global_batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--optimizer", default="kfac",
                    choices=["kfac", "sgd_momentum", "adam"])
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="learning rate for the first-order baselines")
    ap.add_argument("--lambda_init", type=float, default=10.0)
    ap.add_argument("--inv_mode", default="blkdiag",
                    choices=["blkdiag", "tridiag", "eigen"])
    ap.add_argument("--refresh_mode", default="serial",
                    choices=["serial", "staggered"],
                    help="how the T3 inverse refresh executes: serially, "
                         "or staggered over T3 steps (sharded and overlap "
                         "wait for the distributed slice)")
    ap.add_argument("--tau1", type=float, default=1.0,
                    help="fraction of the batch the statistics pass reads")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch_cfg = (get_reduced_config(args.arch) if args.reduced
                else get_config(args.arch))
    if cfg is not None and cfg.name != arch_cfg.name:
        raise ValueError(f"cfg {cfg.name!r} is not --arch's "
                         f"{arch_cfg.name!r}")
    cfg = cfg or arch_cfg
    kcfg = KFACConfig(**{**dict(lambda_init=args.lambda_init,
                                inv_mode=args.inv_mode,
                                refresh_mode=args.refresh_mode,
                                tau1=args.tau1, t3=5), **(kfac_kw or {})})
    lm = LM(cfg, kcfg, device=args.device)
    opt = optimizers.get(args.optimizer, lm, kfac_cfg=kcfg,
                         device=args.device, lr=args.lr)
    if wrap_opt is not None:
        opt = wrap_opt(opt)
    params = lm.init_params(
        torch.Generator(device=lm.device).manual_seed(0))
    log(f"[train] arch={cfg.name} params={lm.n_params():,} "
        f"optimizer={opt.name} device={lm.device}")
    data = _ArchData(cfg, SyntheticLMData(cfg.vocab_size, args.seq,
                                          args.global_batch,
                                          device=args.device))
    tcfg = TrainConfig(steps=args.steps,
                       checkpoint_every=max(10, args.steps // 2))
    ckpt = (Checkpointer(args.ckpt_dir, keep=tcfg.keep_checkpoints)
            if args.ckpt_dir else None)
    trainer = Trainer(lm, opt, tcfg, device=args.device, checkpointer=ckpt)
    result = trainer.fit(params, data, args.steps, log=log)
    hist = result["history"]
    if not hist:      # resumed at or past --steps
        log(f"[train] done: no step left before step {args.steps}")
        return result
    log(f"[train] done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}"
        f" in {result['seconds']:.1f}s")
    return result


if __name__ == "__main__":
    main()
