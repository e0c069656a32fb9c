#!/usr/bin/env python3
"""The conv classifier's fixed learning rate for the fused fixed-lr chain
(``KFACConfig(use_rescale=False)``): a grid of ``fixed_lr`` and ``kl_clip``
run through ``Trainer.fit`` at full width (``configs/conv_classifier.py::
CONFIG``), N images a step, 25 steps, weights from seed 0 and the data
from seed 7, as ``chip_smoke.py``'s "conv" phase runs it:

    PYTHONPATH=src python3 tools/conv_lr_sweep.py [--device cpu] [--n 64]

from the repository root.  Prints one line a configuration: the loss at
steps 0, 12 and 24, the mean of the last five, and the last accuracy.
"""
from __future__ import annotations

import argparse
import itertools
import math

import torch

from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.configs.conv_classifier import CONFIG
from repro_torch.data.pipeline import SyntheticImageData
from repro_torch.models.convnet import ConvNet
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer


def run(lr: float, clip: float, n: int, steps: int, device: str) -> list:
    net = ConvNet(CONFIG, device=device)
    params = net.init_params(torch.Generator().manual_seed(0))
    data = SyntheticImageData(CONFIG.image_size, CONFIG.channels,
                              CONFIG.n_classes, n, seed=7, device=device)
    cfg = KFACConfig(inv_mode="blkdiag", inverse_method="ns",
                     use_rescale=False, fixed_lr=lr, fixed_momentum=0.9,
                     kl_clip=clip, lambda_init=3.0, t3=5, eta=1e-5)
    trainer = Trainer(net, kfac(net, cfg, family="categorical",
                                device=device),
                      TrainConfig(steps=steps, seed=0, log_every=steps),
                      device=device)
    return trainer.fit(params, data, steps=steps, log=lambda m: None)[
        "history"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[0.02, 0.05, 0.1, 0.2, 0.5, 1.0])
    ap.add_argument("--kl_clip", type=float, nargs="+",
                    default=[1e-3, 1e-2, 0.0])
    args = ap.parse_args()
    print(f"conv classifier fused chain, N = {args.n}, {args.steps} steps, "
          f"{args.device}; ln {CONFIG.n_classes} = "
          f"{math.log(CONFIG.n_classes):.4f}")
    for clip, lr in itertools.product(args.kl_clip, args.lr):
        hist = run(lr, clip, args.n, args.steps, args.device)
        losses = [h["loss"] for h in hist]
        tail = sum(losses[-5:]) / len(losses[-5:])
        mid = losses[len(losses) // 2]
        print(f"kl_clip {clip:g} fixed_lr {lr:g}: loss {losses[0]:.4f} → "
              f"{mid:.4f} → {losses[-1]:.4f}; last five {tail:.4f}; "
              f"accuracy {hist[-1]['accuracy']:.3f}", flush=True)


if __name__ == "__main__":
    main()
