#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the repository root, on a machine with one H100.  Phases, each fatal
on failure (nothing is caught):

1. device   fail unless ``torch.cuda.is_available()``; print the card, the
            device count and ``nvidia-smi``'s name and power limit.  TF32 is
            off everywhere: ``torch.backends.cuda.matmul.allow_tf32 = False``
            and ``torch.backends.cudnn.allow_tf32 = False``.
2. build    ``nvcc`` builds ``src/repro_torch/csrc/*.cu`` for sm_90a into
            ``build/`` (one process per source, started together); print the
            ``-Xptxas -v`` register / shared-memory lines and the seconds.
3. kernels  at the main paths' shapes, each kernel against its plain PyTorch
            version on the card, normwise: max|kernel - plain| <= 1e-4 *
            max|plain| (fp32 sums over K <= 8192); the update chain's ΣD² to
            relative 1e-4.  factor_update is held to 1e-4 * max|alpha * XᵀX|
            instead, at beta = 0 (the first step) and at beta = 0.95, so
            that beta * C cannot hide an error in the product.  The two
            decode kernels are held to 1e-5 * max|plain|: every group size
            G = 1..4 with and without a window and a softcap, then
            llama3.2-1b's serving shapes (16 rows, Hq 32, Hkv 8, hd 64,
            ragged lengths 1-4096, a dense bf16 cache and page pools of 8
            with a shuffled page table).  Each kernel is timed beside its
            plain version and the library calls the port never calls, two
            ways: device time, replaying a CUDA graph of the launches
            between CUDA events (``ms``); and eager, CUDA events around
            back-to-back calls, where the host's issue rate shows for short
            launches (``eager_ms``).  Also times ``torch.linalg.eigh`` of
            the 16 factors (the eigen refresh).  The decode kernels also
            at gemma2-2b's serving shapes (16 rows, Hq 8, Hkv 4, hd 256,
            lengths 1-8192, window 4096, softcap 50), each timed case
            with the n_split its wrapper launched (the split over the
            keys, the wrapper's ``last_split``), one row,
            one KV head at S 8192 (the most splits), with and without a
            window and a softcap, and the host's cost of a paged
            call with one split and with a split.  flash_attention is
            held to 1e-5 * max|plain| on small ragged cases (G = 1..4, every
            hd of HEAD_DIMS, lengths no 64-key tile divides, causal or not,
            windows whose edge falls inside a key tile, a softcap, Tk < Tq
            with rows with no valid key, Tk > Tq; a second call bitwise
            equal), after its registers, spills (a spill fails) and blocks
            an SM by head dim; then at the prefill's shapes, each timed:
            llama3.2-1b's 1024-token layer (beside SDPA), gemma2-2b's
            6000-token local and global layers.  Where a softcap is on
            (gemma2), the library call is ``flex_attention`` under
            ``torch.compile`` with a softcap ``score_mod`` and a block mask
            of the causal, window and length masks.  factor_update also
            batched, as the LM's stacked layers send it ((12, 12000, 768),
            (12, 512, 3072), (12, 12000, 3072)), and timed there beside
            ``baddbmm``; with a C that is not symmetric (alpha = 1 - eps),
            unbatched and batched; at each tile and a forced split of
            (777, 251); with 4-byte copies of an x off a 16-byte boundary;
            its registers and spills are printed from the build log and a
            spill fails the phase.  patch_factor is held to
            1e-4 * max|alpha * P̂ᵀP̂| at beta = 0 and 0.95 on ragged cases
            (C 13 and 136, t_out 21, taps over t, t < taps, odd-length
            stride 2, VALID without bias) and at whisper-small's conv
            stems, x (8, 3000, 80) k 3 s 1 and x (8, 3000, 768) k 3 s 2
            ("SAME"), and timed there beside its plain version and
            unfold + addmm; also with a C that is not symmetric (alpha =
            1 - eps) at a ragged case, d = 65 and 129 and conv2.
            matmul_rescale also at the main loop's edges: K = N = 30 and
            250 (4-byte copies), a B off a 16-byte boundary and a split K.
            matmul (the 128 or the 64 tile, K whole or split, from
            ``gemm_plan.dense_plan``) also at whisper-small's stacked
            Newton-Schulz step, M and X (12, 768, 768) and (12, 3072,
            3072), timed beside bmm + baddbmm; each timed unit's matmul
            plans are printed, and its registers and spills at both tiles
            from the build log (over 128 or a spill fails the phase).
            axpy_momentum (the main loop's 64 tile, K whole) at the 8
            layers, alpha and mu on the device; its launches (copy widths)
            and the chain's plans (matmul, then axpy) are printed, and the
            registers and spills of its 4 main-loop instantiations (over
            128 or a spill fails the phase).  These, matmul_rescale, the
            update chain, patch_factor and factor_update print
            their share of the bound and achieved TFLOP/s
            (``tools/plan_sweep.py`` times the launch plans their planner
            weighs; it is not a phase of this script).
4. agree    the reduced autoencoder (64-32-16-8 mirrored, N = 256) for 6
            K-FAC steps on the card and on the CPU (plain versions), same
            weights and uniforms, on each path of phase 5 and on tridiag
            with the fused chain: losses within rtol 1e-3.
            Reduced smollm-135m, llama3.2-1b and gemma2-2b served on the
            card and on the CPU from the same weights: prefill and paged
            decode logits within 1e-4 * max|cpu logits|, each decode step
            taken by both from one shared bf16 cache; the engine's greedy
            tokens equal, or differing only at a proven near tie.
            Reduced whisper-small, 4 K-FAC steps of the launcher's setup
            on the card and on the CPU, same weights and uniforms: losses
            within rtol 1e-3.  The first-order baselines, 6 reduced-
            autoencoder steps of SGD with momentum (lr 0.1) and Adam (lr
            1e-2) on the card and on the CPU: losses within rtol 1e-3.
5. main     ``Trainer.fit`` on the full-width 784-1000-500-250-30 mirrored
            autoencoder, N = 8192 full batch, 25 steps (warmup refreshes,
            T3 refreshes, lambda steps and one gamma sweep), on four paths
            (lambda_init = 3, T3 = 5, eta = 1e-5, T1 = 5, T2 = 20):
              blkdiag  ns inverses, the exact-F 2x2 quadratic model;
              eigen    EKFAC: eigh bases, the rotate_rescale apply;
              fused    ns inverses, use_rescale=False: the update_chain
                       kernel, fixed lr 0.02, momentum 0.9, KL clip 1e-3;
              tridiag  block-tridiagonal F̂⁻¹ = Ξᵀ Λ Ξ (S4.3): the cross
                       moments, Ψ/Σ cache (cuSOLVER eigh) and apply as
                       plain products, the per-layer ns refresh the
                       reference keeps; the quadratic model as blkdiag's.
                       No precondition, update_chain or rotate_rescale
                       launch.
            Launch counters are zeroed just before each path and read just
            after; every kernel of the path must have launched, with the
            counts its schedule implies, and the loss must be finite and
            falling.  On the clipped (fused) path the applied clip factor
            nu of every step must lie in (0, 1] and the applied step's norm
            must be finite and above 0; both are printed per step.
   modes    tau1-subsampled statistics, stats_period, the staggered inverse
            refresh and the Gaussian loss.  First the kernels in the
            regimes these send them, each against its plain version
            (``modes_kernel_rows``): factor_update at tau1 = 1/8's 1024
            rows of the 16 sides and on strided views x[::8] (timed there:
            row 2's ``tau1`` case), ``ns_inverse`` hot-started from a stale
            inverse for 4 iterations, patch_factor on half of whisper's
            batch (conv1 on the strided view mels[::2]).  Then phase 4's
            reduced agreement and phase 5's full-width run on each path
            (the full-width runs after a second blkdiag run, the modes'
            baseline in the same stretch of the process):
              tau1               blkdiag, tau1 = 1/8 (statistics on 1024
                                 of the 8192 rows);
              stats_period2      blkdiag, the factors on even steps only;
              staggered          blkdiag, refresh_mode="staggered": after
                                 the warmup one group of
                                 ``stagger_groups()`` a step (LPT bins of
                                 the d³ cost), NS hot at ns_hot_iters = 4;
              staggered_eigen    eigen, staggered (the group's eigen
                                 states);
              staggered_tridiag  tridiag, staggered (its chain cache is
                                 recomputed only in the warmup and the
                                 sweep, as in the reference);
              gaussian           blkdiag, MLP(loss="gaussian") and
                                 family="gaussian".
            Exact launch counts (the staggered ns_step counts derived from
            the engine's groups), the loss finite and falling; printed
            beside phase 5's runs: the plain-step medians, the staggered
            paths' largest step after the warmup and stats_period2's steps
            with and without a statistics pass.  Its whisper run follows
            the whisper phase, after serving: ``launch/train.py --tau1 0.5
            --refresh_mode staggered``, 6 steps, patch_factor exactly twice
            a step on the 4-sequence sub-batch, every launch count exact.
   race     the optimizer race of ``benchmarks/bench_optimizer_race.py``
            at full width: phase 5's autoencoder, weights and data, 25
            steps of ``Trainer.fit`` each of SGD with momentum 0.9 at lr
            0.03, 0.1 and 0.3, Adam at lr 1e-2 and blkdiag K-FAC without
            momentum; phase 5's blkdiag and tridiag runs are the K-FAC
            rows kfac_blkdiag and kfac_tridiag.  Per row the
            per-step host ms (``timed``), the plain-step median and the
            total, the final loss, peak memory and exact launch counts
            (none for SGD and Adam); then the time to the target, the best
            SGD row's final loss: each row's first step at or below it and
            its host ms summed through that step; likewise to the best
            first-order row's final loss.  Fails unless every loss
            is finite and K-FAC ends below the best SGD row (the claim of
            ``examples/autoencoder_kfac.py``); the momentum, Adam and
            tridiag (at or below blkdiag) orderings are printed, not held.
   ckpt     checkpoints, resume, preemption and the curvature bundle, each
            in a ``tempfile.mkdtemp()`` directory (its disk usage printed
            first, removed after).  On phase 5's four paths with its
            model, weights and data: ``Trainer.fit`` to step 7 with an
            asynchronous ``Checkpointer`` (``checkpoint_every=7``; on
            blkdiag and eigen also ``curvature_every=7``), then a new
            optimizer and trainer resume from step 7 to 12.  Held: every
            array of ``arrays.npz`` bitwise a host copy taken at the save;
            steps 0-6 and the resumed first loss bitwise phase 5's; exact
            launch counts of both runs, the resumed one's with its warmup
            re-armed at step 7 (``ae_launches``: refreshes at 7, 8,
            9 and 10); finite losses; the checkpoint restored into a CPU
            template bitwise (tridiag's Ψ/Σ cache None, as in the
            reference); on blkdiag a second resume bitwise the first.  The
            bundle: on eigen its qa / qg / s / damp bitwise the state's
            ``inv``, and a bfloat16 bundle's bases bitwise
            ``q.to(torch.bfloat16).float()``; on blkdiag the rotate_rescale
            apply of the loaded bundle against the precondition kernel on
            the eigh-damped inverses of the same factors and γ, within
            min(5e-6·κ, 2e-3)·max|U| (κ = max/min of s + damp).
            Preemption once on blkdiag: SIGTERM while step 3's batch is
            built; ``fit`` stops after step 3 with a committed
            ``step_00000004``, and the SIGTERM handler is afterwards what
            it was before.  Printed:
            bytes, the save's blocking host-copy ms and its write seconds
            on the thread, the restore's read and to-device seconds, the
            bundle's snapshot ms and write seconds.  whisper: the whisper
            phase's 10-step run goes through ``--ckpt_dir`` (its checkpoint
            after step 10, outside the step times; the free disk checked
            against the checkpoint's bytes from the metas first), then a
            relaunch with ``--steps 12`` resumes at step 10 and runs two
            steps (both warmup refreshes) with exact launch counts and a
            finite loss, the device's peak during the restore printed.
   conv     KFC convolutions and the backward-pass fused statistics
            (``fused_stats``).  First factor_update at every factor side
            of one full-width conv classifier step (``CONV_SIDES``: the
            im2col rows of conv0, (524288, 28), conv1, (131072, 289), and
            conv2, (32768, 289), each layer's G side, the head's) against
            its plain version at beta = 0 and 0.95, held as phase 3 holds
            it, conv0's and conv1's A sides timed beside addmm with their
            launch plans and bounds.  Then the reduced conv classifier
            (8x8x2, convs (8, 3, 1) and (8, 3, 2), 4 classes, N = 128) 6
            steps on the card and on the CPU, same weights and uniforms,
            on blkdiag (ns), eigen and the fused chain, each two-pass and
            with ``fused_stats`` (``_fs``): losses within rtol 1e-3.  Then
            ``Trainer.fit`` of the full-width conv classifier (32x32x3,
            convs (32, 3, 1), (32, 3, 2), (64, 3, 2), 10 classes; N = 512
            images a step from seed 7; weights from seed 0) for 25 steps
            on each of those six paths: exact launch counts, the loss
            finite and falling, plain-step and refresh-step ms of
            ``opt.update``, peak memory, the accuracy.  Then the
            full-width autoencoder with ``fused_stats`` on blkdiag and
            eigen: one statistics pass against the two-pass one (every
            factor within 1e-5 of its scale), 25 steps with exact launch
            counts, the losses against phase 5's two-pass run (step 0
            equal, then 5e-3 relative through step 19 and 2% after).
6. serve    ``Engine.run`` on full-width llama3.2-1b (16 layers, d 2048,
            vocab 128256, float32 weights from seed 0, bf16 paged KV cache):
            32 greedy requests with prompts of 64-1024 tokens, 64 new
            tokens each, 16 slots, max_len 2048, pages of 8.  Then the
            first 16 requests through a pool with 16 pages beyond their
            prompts' (preemptions must happen, and the tokens must equal
            the first run's), and the first 16 for 4 tokens on the gather
            route (tokens equal to the paged route's).  Then full-width
            gemma2-2b (26 layers, d 2304, hd 256, vocab 256000, local
            layers with a window of 4096, softcaps 50 and 30): 16 greedy
            requests, prompts of 6000, 5000 and 14 lengths in 64-4096, 32
            new tokens each, 16 slots, max_len 8192, pages of 8; then the
            first four for 4 tokens on the gather route (tokens equal).
            Launch counters are zeroed just before each run and read just
            after: every decode step launches its route's kernel once per
            layer, every prefill call flash_attention once per layer, and
            nothing else launches.  Prints the engine's TTFT, decode-step
            and prefill times, tokens/s, peak memory and the device time of
            a step's logits copy to the host; then ten decode steps of 16
            rows under ``torch.profiler`` (for gemma2 also the admission's
            prefills).
   whisper  full-width whisper-small (12 + 12 layers, d 768, d_ff 3072,
            vocab 51865, 80 mels x 3000 frames; 336,471,552 float32
            parameters from seed 0) through ``launch/train.py``'s ``main``
            for 10 steps (batch 8, seq 64, lambda_init 10, T3 5, blkdiag
            ns): exact launch counts (patch_factor twice a step), the loss
            finite and falling, per-step host times and peak memory.  It
            runs after serving, so that the serve phase meets the process
            as it did before this path was ported.  Then 3 Adam steps
            (lr 1e-3) through ``launch/train.py --optimizer adam``: the
            loss finite, no kernel launched, plain-step median and peak
            memory.
   decoders K-FAC training of the dense decoders (``decoders_phase``).
            First the kernels at full-width llama3.2-1b's shapes, each
            against its plain version as phase 3 holds it and timed beside
            the library calls with its plans and bound: factor_update
            batched over the 16 stacked layers, X (16, 512, d) for d in
            2048, 8192 and 512, at beta = 0 and 0.95 (beside baddbmm); one
            ns_step on (16, 8192, 8192) and (16, 2048, 2048) stacks (bmm +
            baddbmm); precondition on the 7 stacked layer shapes (bmm +
            bmm).  Then reduced smollm-135m and llama3.2-1b 4 K-FAC steps
            on the card and on the CPU, same weights and uniforms: losses
            within rtol 1e-3.  Then through ``launch/train.py``'s ``main``
            at its defaults (batch 8, seq 64, lambda_init 10, T3 5, blkdiag
            ns; weights from seed 0): full-width smollm-135m (30 layers, d
            576, 9 query heads over 3 KV heads, d_ff 1536, vocab 49152,
            tied head) 25 steps, through the step-20 γ sweep, then 3 Adam
            steps (no launch); full-width llama3.2-1b (16 layers, d 2048,
            32 over 8 heads, d_ff 8192, vocab 128256, tied head) 6 steps:
            the warmup refreshes, the lambda step at 4, the T3 refresh at
            5.  Exact launch counts (``lm_launches``), the loss finite
            and below its first value at the last step, plain-step,
            refresh-step and sweep-step ms, the memory allocated, reserved
            and free before each run and its peak beside the reckoning of
            ``decoder_memory``.
   gemma2   block-diagonal factors and gemma2-2b's K-FAC training
            (``gemma2_phase``).  ``memory_table``: ``decoder_memory`` of
            smollm-135m, llama3.2-1b and gemma2-2b at 26 and at 12 layers
            (a block side counted as nb·db² floats).  The kernels at the
            12-layer gemma2-2b's shapes: factor_update on the d_ff side's
            block rows X (12, 512, 4608) (6 stacked layers × 2 blocks of
            4608 in the batch) and the full sides' (6, 512, d), d 2304,
            2048 and 1024, at beta = 0 and 0.95 (beside baddbmm); one
            ns_step on (12, 4608, 4608) and (6, 2304, 2304) (bmm +
            baddbmm); the apply of the 14 stacked layers through their
            curvature blocks (matmul with the blocks in its batch on gate,
            up and down; precondition on the rest) against
            ``apply_block_inverse`` (bmm / batched matmul).  Then reduced
            gemma2-2b 4 K-FAC steps on the card and on the CPU at
            ``max_factor_dim`` 64 and 48, so that the block route runs:
            losses within rtol 1e-3.  Then gemma2-2b at full width (d 2304,
            8 over 4 heads of 256, d_ff 9216, vocab 256000, window 4096,
            softcaps 50 and 30, tied head) cut to 12 layers (the 26 do not
            fit the card: ``decoder_memory``) through ``launch/train.py``'s
            ``main(..., cfg=...)`` 6 steps at its defaults, exact launch
            counts (``lm_launches``), the loss finite, step ms, memory
            before and peak beside the reckoning; then 3 Adam steps.
   lm_eigen eigen mode (EKFAC), the fused fixed-lr chain, ``fused_stats``
            and the curvature bundle on the LMs (``lm_eigen_phase``).  The
            kernels' new shapes, each against its plain version: the
            batched rotate_rescale at smollm-135m's 7 stacked layers (S =
            30) and whisper-small's (12, 768, 3072) / (12, 3072, 768) (bmm,
            div, bmm, bmm, bmm); the block eigen apply of gemma2-2b's gate,
            up and down at the eigen run's depth (four matmul launches, a
            block side's blocks in their batch; bmm / batched matmul); the
            batched precond_momentum and axpy_momentum at smollm-135m's
            stacked layers, ΣD² to relative 1e-4 (bmm, baddbmm, sum).
            Reduced smollm-135m, gemma2-2b at ``max_factor_dim`` 64 and
            whisper-small, 4 steps on the card and on the CPU in eigen mode,
            on the fused chain (momentum 0.9, KL clip 1e-3) and with
            ``fused_stats`` (eigen): losses within rtol 1e-3.  Full width
            through ``launch/train.py`` with exact launches
            (``lm_launches``), losses finite, every update applied and the
            peak within 10% of the path's reckoning (``decoder_memory``'s
            eigen and chain columns): smollm-135m in eigen mode 25 steps
            (the γ sweep at 20) and on the fused chain (lr 0.05) 25 steps;
            whisper-small in eigen mode with ``fused_stats`` 6 steps (its
            reckoning: the blkdiag whisper run's peak plus s and damp);
            gemma2-2b in eigen mode at the deepest even cut whose eigen
            reckoning leaves 25% of the card's free memory
            (``gemma2_eigen_layers``: 6 layers), 6 steps, before its
            sweep.  The bundles of the smollm chain's last state (a fresh
            eigh of its factors) and of whisper's live eigen state, written
            by ``BundleWriter`` and read back bit for bit, their apply held
            to the eigh-damped inverses' within min(5e-6·κ, 2e-3) and to
            the live engine's eigen apply within 1e-5.
7. profile  each autoencoder path twice more: per-stage host times
            (synchronized; on tridiag also each eigh of the refresh stage,
            and eigh's share of each refresh step), then device time by
            kernel under ``torch.profiler``; whisper's steps 3 and 4 of
            another run under ``torch.profiler``, with factor_update's
            device ms.  The
            profiles come last, so that no profiled window precedes a
            timed path.
8. summary  the ``{"main": ...}`` (the modes' runs under ``modes_*``, the
            ckpt phase's under ``ckpt_*``, the fused autoencoder's under
            ``ae_fs_*``), ``{"serve": ...}``, ``{"race": ...}``,
            ``{"conv": ...}``, ``{"decoders": ...}``, ``{"gemma2": ...}``,
            ``{"lm_eigen": ...}`` and ``{"kernels": [...]}`` lines, the
            nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Bounds are the larger of fp32 operations over 67 TFLOP/s and bytes over
3.35 TB/s (H100 SXM data sheet, at a 700 W power limit).  factor_update's
counts N·d(d+1) operations per side: XᵀX is symmetric, so only its
d(d+1)/2 distinct entries need a 2N-operation sum each.  A decode call's
counts the K/V rows of the valid keys of its lengths, read once.  A
flash_attention call's counts 4·hd·Hq·Σᵢnᵢ operations (nᵢ the keys query
row i sees) against q, k, v and the output moved once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FP32_FLOPS = 67e12         # H100 SXM fp32, no tensor cores
HBM_BYTES = 3.35e12        # H100 SXM HBM3
N_ROWS = 8192
TOL = 1e-4                 # normwise, against max|plain|
DECODE_TOL = 1e-5          # the decode kernels: float32 sums of <= 8192 keys
ATTN_TOL = 1e-5            # flash_attention: float32 sums of <= 6000 keys
# Serving logits, cuda vs cpu from one shared bf16 cache: each device still
# rounds the step's own new K/V row to bf16, and a float32 value on a
# rounding boundary may round the other way (one bf16 ulp, ~0.4% of that
# entry), which moved reduced smollm's logits by 1.7e-5 of their scale on
# an H100; held at about six times that.
SERVE_TOL = 1e-4


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed(opt, step_ms: list):
    """``opt`` with each update's time in ms appended to ``step_ms``: the
    host clock between synchronizes just before and just after
    ``opt.update`` (the step time of every training path here)."""
    def update(*args, _update=opt.update):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _update(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    return dataclasses.replace(opt, update=update)


def eager_ms(fn, reps: int = 10) -> float:
    """CUDA events around ``reps`` back-to-back calls of ``fn`` after one
    warmup: for short launches this is the host's issue rate (allocations,
    ctypes calls, Python), not the device's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=None)
def _capture_stream() -> torch.cuda.Stream:
    # One stream for every warmup and capture: cuBLAS keeps a workspace per
    # stream for the life of the process, which the main path's peak
    # memory would otherwise count once per stream.
    return torch.cuda.Stream()


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn``: its launches are captured once into a CUDA
    graph, which is replayed ``reps`` times between CUDA events, so no host
    work lies between the launches."""
    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def timings(kernel, plain, library, reps: int = 10) -> dict:
    """Device and eager times of the kernel, its plain version and the
    library call (None where no one PyTorch call computes the function),
    each over the same work."""
    fns = {"ms": kernel, "plain_ms": plain, "library_ms": library}
    out = {key: None if fn is None else graph_ms(fn, reps)
           for key, fn in fns.items()}
    out["eager_ms"] = {key: None if fn is None else eager_ms(fn, reps)
                       for key, fn in fns.items()}
    return out


def fmt_ms(x) -> str:
    return "none" if x is None else f"{x:.4f}"


def compare(name, got, want, errs, scale=None, tol=TOL):
    """max|got - want| <= tol * scale, with scale max|want| by default."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item() if scale is None else scale
    ok = math.isfinite(err) and err <= tol * scale
    print(f"  {name:48s} max|err| {err:.3e}  scale {scale:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol} * {scale:.3e})")
    errs.append(err)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


class DeviceEvent(NamedTuple):
    """One device event name of a ``torch.profiler`` run, summed as
    ``key_averages()`` sums it."""
    key: str
    count: int
    self_device_time_total: float      # us


def _device_events(prof) -> list:
    """The run's device events (kernels, copies, sets) summed by name,
    read from the kineto events themselves: ``key_averages()`` first builds
    an event of every CPU op with its stack, which took 12–78 s a profile
    on an H100's host (whisper's two steps 69 s), for the same sums."""
    from torch.autograd import DeviceType
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        us = (e.duration_ns() / 1e3 if hasattr(e, "duration_ns")
              else e.duration_us())
        n, t = sums.get(e.name(), (0, 0.0))
        sums[e.name()] = (n + 1, t + us)
    return [DeviceEvent(k, n, t) for k, (n, t) in sums.items()]


def device_kernels(prof) -> tuple:
    """Device busy ms of a ``torch.profiler`` run, and its ten busiest
    kernels as (device ms, launches, name)."""
    kernels = sorted(_device_events(prof), key=_device_us, reverse=True)
    top = [(_device_us(e) / 1e3, e.count, e.key[:120]) for e in kernels[:10]]
    for ms, n, key in top:
        print(f"  {ms:9.3f} ms {n:6d}x  {key[:90]}")
    return sum(_device_us(e) for e in kernels) / 1e3, top


def profile_path(label, mlp, params, data, cfg, steps) -> dict:
    """Where the time goes: one path twice more (after its launch counts
    were read) — once with each pipeline stage timed on the host clock
    between synchronizes, once under ``torch.profiler`` for the device time
    by kernel and the device busy share.  On the tridiag path the first run
    also times every ``torch.linalg.eigh`` call (a synchronize on each
    side) inside the refresh stage: eigh's share of each refresh step."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.optimizers.kfac import Stage, kfac
    from repro_torch.training.trainer import Trainer

    def fit(opt):
        trainer = Trainer(mlp, opt, TrainConfig(steps=steps, seed=0,
                                                log_every=10 ** 9),
                          device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(params, data, steps=steps, log=lambda *_: None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    opt = kfac(mlp, cfg, family="bernoulli", device="cuda")
    pipe = opt.update.__self__
    stage_ms = collections.defaultdict(list)

    def timed(stage):
        def run(ctx):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage.run(ctx)
            torch.cuda.synchronize()
            stage_ms[stage.name].append((time.perf_counter() - t0) * 1e3)
        return Stage(stage.name, run)

    pipe.stages = [timed(st) for st in pipe.stages]
    eigh = {"ms": [], "matrices": 0}     # ms: per refresh-stage call
    real_eigh = torch.linalg.eigh

    def eigh_timed(m, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eigh(m, *args, **kw)
        torch.cuda.synchronize()
        eigh["ms"][-1] += (time.perf_counter() - t0) * 1e3
        eigh["matrices"] += math.prod(m.shape[:-2])
        return out

    time_eigh = cfg.inv_mode == "tridiag"
    if time_eigh:
        refresh = next(i for i, st in enumerate(pipe.stages)
                       if st.name == "scheduled_inverse_refresh")
        inner = pipe.stages[refresh]

        def refresh_run(ctx):
            eigh["ms"].append(0.0)
            torch.linalg.eigh = eigh_timed
            try:
                inner.run(ctx)
            finally:
                torch.linalg.eigh = real_eigh

        pipe.stages[refresh] = Stage(inner.name, refresh_run)
    wall_ms = fit(opt)
    print(f"[profile:{label}] stages, {steps} steps in {wall_ms:.1f} ms "
          f"(host clock, a synchronize around every stage)")
    for name, v in stage_ms.items():
        srt = sorted(v)
        print(f"  stage {name:44s} total {sum(v):9.3f} ms  median "
              f"{srt[len(srt) // 2]:8.3f}  max {srt[-1]:8.3f}")
    extra = {}
    if time_eigh:
        step_ms = [sum(v[i] for v in stage_ms.values())
                   for i in range(steps)]
        hit = [i for i, t in enumerate(eigh["ms"]) if t > 0]
        extra["eigh"] = {
            "steps": hit, "eigh_ms": [eigh["ms"][i] for i in hit],
            "step_ms": [step_ms[i] for i in hit],
            "matrices": eigh["matrices"],
            "share": sum(eigh["ms"]) / sum(step_ms[i] for i in hit)}
        print(f"  eigh: {eigh['matrices']} matrices on refresh steps "
              f"{hit}; ms {[round(eigh['ms'][i], 3) for i in hit]} of "
              f"steps {[round(step_ms[i], 3) for i in hit]} "
              f"({extra['eigh']['share']:.1%} of those steps' stage time)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = fit(kfac(mlp, cfg, family="bernoulli", device="cuda"))
    print(f"[profile:{label}] torch.profiler, {steps} steps in "
          f"{wall_ms:.1f} ms; busiest kernels:")
    busy_ms, _ = device_kernels(prof)
    print(f"  device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "stage_total_ms": {k: sum(v) for k, v in stage_ms.items()},
            **extra}


# ---------------------------------------------------------------------------
# serving: the decode kernels, the cuda-vs-cpu agreement, the serve path
# ---------------------------------------------------------------------------

def decode_bound(lengths, s_len, hq, hkv, hd, page=0, window=0) -> tuple:
    """Least time of one decode call on these lengths: the valid keys' K/V
    rows read once (bf16; the last ``window`` of each row's keys with a
    window), q read and the output written once (float32), the lengths and
    the page-table entries of the touched pages read once; against 4
    operations per (valid key, query head, dim)."""
    spans = [(max(0, int(n) - window) if window else 0, min(int(n), s_len))
             for n in lengths.tolist()]
    keys = [hi - lo for lo, hi in spans]
    nbytes = (2.0 * sum(keys) * hkv * hd * 2 + 2.0 * len(keys) * hq * hd * 4
              + 4.0 * len(keys))
    if page:
        nbytes += 4.0 * sum((hi - 1) // page - lo // page + 1
                            for lo, hi in spans)
    return bound_ms(4.0 * sum(keys) * hq * hd, nbytes)


def sdpa(q, k, v, lengths):
    """The library call: ``scaled_dot_product_attention`` on bf16 q/k/v
    (B, H, 1, hd) x (B, Hkv, S, hd) with GQA and a (B, 1, 1, S) length
    mask.  It takes q in bf16 (SDPA wants one dtype), so it is the same
    function up to q's rounding."""
    import torch.nn.functional as F
    pos = torch.arange(k.shape[2], device=q.device)
    valid = pos[None, :] < lengths[:, None]
    return F.scaled_dot_product_attention(
        q.to(torch.bfloat16)[:, :, None], k, v, attn_mask=valid[:, None, None],
        enable_gqa=True)


@functools.lru_cache(maxsize=None)
def _flex():
    """``flex_attention`` under ``torch.compile``, as it is meant to run:
    the library call for attention with a softcap, which the port never
    calls."""
    from torch.nn.attention.flex_attention import flex_attention
    return torch.compile(flex_attention, dynamic=False)


@functools.lru_cache(maxsize=None)
def _softcap(cap):
    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)
    return score_mod


def flex_mask(tq, tk, *, causal=True, window=0, lengths=None):
    """The block mask of ``flex_softcap``: query i (the key at ``lengths[b]
    - 1`` for a decode row) sees key j when causal and window allow it;
    built once, outside the timed calls."""
    from torch.nn.attention.flex_attention import create_block_mask
    if lengths is None:
        def mask(b, h, qi, ki):
            ok = (qi >= ki) if causal else (ki >= 0)
            return (ok & (qi - ki < window)) if window else ok
        return create_block_mask(mask, None, None, tq, tk, device="cuda")

    def mask(b, h, qi, ki):
        ok = ki < lengths[b]
        return (ok & (lengths[b] - 1 - ki < window)) if window else ok
    return create_block_mask(mask, lengths.shape[0], None, tq, tk,
                             device="cuda")


def flex_softcap(q, k, v, block_mask, cap):
    """The library call: compiled ``flex_attention`` with cap·tanh(s/cap)
    of the scaled scores, the block mask and GQA."""
    return _flex()(q, k, v, score_mod=_softcap(cap), block_mask=block_mask,
                   enable_gqa=True)


def decode_kernel_rows(dev, g) -> dict:
    """Both decode kernels against their plain versions, to 1e-5 of
    max|plain|.  First small cases: every group size G = 1..4 (hd 64),
    each with no window and no softcap, a window, a softcap and both.  Then
    the shapes the serve path gives them, timed beside the plain version
    and the library call: llama3.2-1b's B = 16 slots, Hq 32, Hkv 8, hd 64,
    ragged lengths 1-4096, a dense (B, S, Hkv, hd) bf16 cache read through
    strides, and page pools of 8 with a shuffled page table; and
    gemma2-2b's, 16 slots, Hq 8, Hkv 4, hd 256, lengths 1-8192, window
    4096, softcap 50, beside ``flex_softcap`` on bf16 q (SDPA has no
    softcap).  Each timed case prints the n_split its wrapper launched
    there (``last_split``).  Then one row and one KV head at S 8192 (hd
    256, G 2): the most splits the rule gives.  Last, the host's cost of a
    paged call at gemma2-2b's shapes with rows of one key, one split
    against a split (the merge's launch; the workspace is the stream's
    own, kept from call to call)."""
    from repro_torch.kernels.flash_decode import (FILL, flash_decode,
                                                  flash_decode_paged,
                                                  flash_decode_paged_ref,
                                                  flash_decode_ref,
                                                  paged_gather)
    from repro_torch.kernels.gemm_plan import sm_count
    errs = {"flash_decode": [], "flash_decode_paged": []}
    wrappers = {"flash_decode": flash_decode,
                "flash_decode_paged": flash_decode_paged}
    sms = sm_count(torch.device(dev).index or 0)

    def case(b, hq, hkv, hd, s_len, page, g=g):
        q = torch.randn(b, hq, hd, generator=g, device=dev)
        lengths = torch.randint(1, s_len + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0], lengths[-1] = 1, s_len
        # dense: the LM's (B, S, Hkv, hd) cache, read through strides
        k, v = (torch.randn(b, s_len, hkv, hd, generator=g, device=dev)
                .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        nb = -(-s_len // page)
        num_pages = 1 + b * nb
        kp, vp = (torch.randn(num_pages, page, hkv, hd, generator=g,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        table = (torch.randperm(num_pages - 1, generator=g, device=dev)
                 + 1).reshape(b, nb).to(torch.int32)
        return q, lengths, k, v, kp, vp, table

    for group in range(1, 5):
        q, lengths, k, v, kp, vp, table = case(3, 2 * group, 2, 64, 200, 8)
        for window, cap in ((0, 0.0), (37, 0.0), (0, 30.0), (37, 30.0)):
            kw = dict(window=window, cap=cap)
            compare(f"flash_decode G={group} window={window} cap={cap}",
                    flash_decode(q, k, v, lengths, **kw),
                    flash_decode_ref(q, k, v, lengths, **kw),
                    errs["flash_decode"], tol=DECODE_TOL)
            compare(f"flash_decode_paged G={group} window={window} "
                    f"cap={cap}",
                    flash_decode_paged(q, kp, vp, lengths, table, **kw),
                    flash_decode_paged_ref(q, kp, vp, lengths, table, **kw),
                    errs["flash_decode_paged"], tol=DECODE_TOL)

    b, hq, hkv, hd, s_len, page = 16, 32, 8, 64, 4096, 8
    q, lengths, k, v, kp, vp, table = case(b, hq, hkv, hd, s_len, page)
    compare(f"flash_decode llama3.2-1b B={b} S={s_len}",
            flash_decode(q, k, v, lengths),
            flash_decode_ref(q, k, v, lengths), errs["flash_decode"],
            tol=DECODE_TOL)
    compare(f"flash_decode_paged llama3.2-1b B={b} page={page}",
            flash_decode_paged(q, kp, vp, lengths, table),
            flash_decode_paged_ref(q, kp, vp, lengths, table),
            errs["flash_decode_paged"], tol=DECODE_TOL)

    def lib_paged():
        kd, vd = paged_gather(kp, vp, table)
        return sdpa(q, kd, vd, lengths)

    shape = (f"llama3.2-1b shapes: B={b}, Hq {hq}, Hkv {hkv}, hd {hd}, "
             f"lengths 1-{s_len}")
    timed = {"flash_decode": timings(
                 lambda: flash_decode(q, k, v, lengths),
                 lambda: flash_decode_ref(q, k, v, lengths),
                 lambda: sdpa(q, k, v, lengths)),
             "flash_decode_paged": timings(
                 lambda: flash_decode_paged(q, kp, vp, lengths, table),
                 lambda: flash_decode_paged_ref(q, kp, vp, lengths, table),
                 lib_paged)}
    bounds = {"flash_decode": decode_bound(lengths, s_len, hq, hkv, hd),
              "flash_decode_paged": decode_bound(lengths, s_len, hq, hkv, hd,
                                                 page)}
    for name, r in timed.items():
        r["n_split"] = wrappers[name].last_split
        print(f"  {name} at {shape}: n_split {r['n_split']}, kernel "
              f"{r['ms']:.4f} [{r['eager_ms']['ms']:.4f}] ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"[{r['eager_ms']['library_ms']:.4f}] ms, bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]})")
    del q, lengths, k, v, kp, vp, table

    # gemma2-2b's serving shapes: hd 256, G 2, a window of 4096 and the
    # attention softcap; the library call is flex_attention (bf16 q)
    gb, ghq, ghkv, ghd, gs, gw = 16, 8, 4, 256, 8192, 4096
    q, lengths, k, v, kp, vp, table = case(gb, ghq, ghkv, ghd, gs, page)
    kw = dict(window=gw, cap=50.0)
    dmask = flex_mask(1, gs, window=gw, lengths=lengths)
    qb = q.to(torch.bfloat16)[:, :, None]

    def flex_paged():
        kd, vd = paged_gather(kp, vp, table)
        return flex_softcap(qb, kd, vd, dmask, 50.0)

    lib_err = (flex_softcap(qb, k, v, dmask, 50.0)[:, :, 0].float()
               - flash_decode_ref(q, k, v, lengths, **kw)).abs().max().item()
    print(f"  flex_attention at gemma2-2b's decode shapes, bf16 q: max|err| "
          f"{lib_err:.3e} against the plain version (not held)")
    compare(f"flash_decode gemma2-2b B={gb} S={gs} window={gw}",
            flash_decode(q, k, v, lengths, **kw),
            flash_decode_ref(q, k, v, lengths, **kw), errs["flash_decode"],
            tol=DECODE_TOL)
    compare(f"flash_decode_paged gemma2-2b B={gb} page={page}",
            flash_decode_paged(q, kp, vp, lengths, table, **kw),
            flash_decode_paged_ref(q, kp, vp, lengths, table, **kw),
            errs["flash_decode_paged"], tol=DECODE_TOL)
    gshape = (f"gemma2-2b shapes: B={gb}, Hq {ghq}, Hkv {ghkv}, hd {ghd}, "
              f"lengths 1-{gs}, window {gw}, cap 50")
    gemma = {
        "flash_decode": dict(
            unit=f"one attention layer of one decode step at {gshape}, "
                 f"dense (B, S={gs}, Hkv, hd) bf16 cache",
            **timings(lambda: flash_decode(q, k, v, lengths, **kw),
                      lambda: flash_decode_ref(q, k, v, lengths, **kw),
                      lambda: flex_softcap(qb, k, v, dmask, 50.0)),
            bound=decode_bound(lengths, gs, ghq, ghkv, ghd, window=gw)),
        "flash_decode_paged": dict(
            unit=f"one attention layer of one decode step at {gshape}, "
                 f"page pools of {page}, shuffled page table",
            **timings(lambda: flash_decode_paged(q, kp, vp, lengths, table,
                                                 **kw),
                      lambda: flash_decode_paged_ref(q, kp, vp, lengths,
                                                     table, **kw),
                      flex_paged),
            bound=decode_bound(lengths, gs, ghq, ghkv, ghd, page, gw))}
    for name, r in gemma.items():
        r["n_split"] = wrappers[name].last_split
        print(f"  {name} at {gshape}: n_split {r['n_split']}, kernel "
              f"{r['ms']:.4f} [{r['eager_ms']['ms']:.4f}] ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"[{r['eager_ms']['library_ms']:.4f}] ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    del q, lengths, k, v, kp, vp, table, qb, dmask
    # one row, one KV head, S 8192: the most splits the rule gives (its own
    # generator, so that every other input stays that of earlier runs)
    q, lengths, k, v, kp, vp, table = case(
        1, 2, 1, 256, 8192, 8, torch.Generator(device=dev).manual_seed(1))
    for window, cap in ((0, 0.0), (4096, 50.0)):
        kw = dict(window=window, cap=cap)
        got = flash_decode(q, k, v, lengths, **kw)
        compare(f"flash_decode B=1 S=8192 n_split={flash_decode.last_split}"
                f" window={window}", got,
                flash_decode_ref(q, k, v, lengths, **kw),
                errs["flash_decode"], tol=DECODE_TOL)
        got = flash_decode_paged(q, kp, vp, lengths, table, **kw)
        compare(f"flash_decode_paged B=1 S=8192 n_split="
                f"{flash_decode_paged.last_split} window={window}", got,
                flash_decode_paged_ref(q, kp, vp, lengths, table, **kw),
                errs["flash_decode_paged"], tol=DECODE_TOL)
    del q, lengths, k, v, kp, vp, table

    # the host's cost of one paged call at gemma2-2b's shapes, rows of one
    # key (next to no device work, so back-to-back calls run at the host's
    # enqueue rate): enough rows for one split, against 16 rows, whose split
    # adds the merge's launch
    gi = torch.Generator(device=dev).manual_seed(2)
    pool = torch.randn(2, page, ghkv, ghd, generator=gi,
                       device=dev).to(torch.bfloat16)
    host_us = {}
    for rows in (-(-FILL * sms // ghkv), gb):
        q = torch.randn(rows, ghq, ghd, generator=gi, device=dev)
        ones = torch.ones(rows, dtype=torch.int32, device=dev)
        table = torch.zeros(rows, gs // page, dtype=torch.int32, device=dev)
        call = functools.partial(flash_decode_paged, q, pool, pool, ones,
                                 table, window=gw, cap=50.0)
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        host_us[f"{rows} rows, n_split {flash_decode_paged.last_split}"] = us
    del q, ones, table, pool
    print(f"  flash_decode_paged host time per call, rows of one key: "
          + ", ".join(f"{k} {v:.2f} us" for k, v in host_us.items()))

    return {
        "flash_decode": dict(
            source="src/repro_torch/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:82",
            unit=f"one attention layer of one decode step at {shape}, dense "
                 f"(B, S={s_len}, Hkv, hd) bf16 cache",
            max_abs_err=max(errs["flash_decode"]),
            **timed["flash_decode"],
            library_calls="scaled_dot_product_attention(enable_gqa, "
                          "length mask), bf16 q; gemma2-2b: compiled "
                          "flex_attention(softcap score_mod, block mask), "
                          "bf16 q",
            bound=bounds["flash_decode"],
            cases={"gemma2-2b": gemma["flash_decode"]}),
        "flash_decode_paged": dict(
            source="src/repro_torch/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:178",
            unit=f"one attention layer of one decode step at {shape}, page "
                 f"pools of {page}, shuffled page table",
            max_abs_err=max(errs["flash_decode_paged"]),
            **timed["flash_decode_paged"],
            library_calls="paged gather + scaled_dot_product_attention("
                          "enable_gqa, length mask), bf16 q; gemma2-2b: "
                          "paged gather + compiled flex_attention(softcap "
                          "score_mod, block mask), bf16 q",
            bound=bounds["flash_decode_paged"], host_us=host_us,
            cases={"gemma2-2b": gemma["flash_decode_paged"]})}


def attention_bound(b, hq, hkv, hd, tq, tk, causal=True, window=0) -> tuple:
    """Least time of one flash_attention call: 4 operations per (valid
    key, query row, head, dim) (a row with no valid key weighs all Tk
    keys), against q, k, v and the output moved once (float32)."""
    i = np.arange(tq)
    hi = np.minimum(tk, i + 1) if causal else np.full(tq, tk)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(tq, int)
    n = np.where(hi > lo, hi - lo, tk)
    return bound_ms(4.0 * hd * hq * b * float(n.sum()),
                    4.0 * hd * (2 * b * hq * tq + 2 * b * hkv * tk))


def attention_kernel_row(dev, g, log) -> dict:
    """flash_attention against its plain version, to 1e-5 of max|plain|,
    on q, k, v as the LM passes them ((B, T, H, hd) projections viewed as
    (B, H, T, hd)).  First its registers, spills (a spill fails) and blocks
    an SM for each head dim, then small cases: every head dim of
    HEAD_DIMS at every group size G = 1..4, lengths that no 64-key tile
    divides, causal or not, a window and a softcap (windows of 9 and 16
    whose edge falls inside a key tile, and of 70, which spans one), the
    causal diagonal crossing key and query tiles; Tk < Tq with a window
    (rows with no valid key) and Tk > Tq; and two calls on the same inputs,
    bitwise equal.  Then the prefill's shapes, each timed beside the plain
    version (and held bitwise on a second call): llama3.2-1b's 1024-token
    layer (B 1, Hq 32, Hkv 8, hd 64, causal), beside
    ``scaled_dot_product_attention(is_causal, enable_gqa)``, which the port
    never calls; gemma2-2b's 6000-token local and global layers (Hq 8, Hkv
    4, hd 256, softcap 50, window 4096 or none), beside ``flex_softcap``
    in float32 (SDPA has no softcap).  The row's headline is gemma2's
    global layer."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     blocks_per_sm,
                                                     flash_attention,
                                                     flash_attention_ref)
    resources = ptxas_resources(log, "attention_kernel")
    for args, regs, st, ld in resources:
        print(f"  attention_kernel<{args}>: {regs} registers, spill stores "
              f"{st} B, loads {ld} B")
    if any(st or ld for _, _, st, ld in resources):
        raise AssertionError(f"flash_attention spills: {resources}")
    occupancy = {hd: blocks_per_sm(hd) for hd in HEAD_DIMS}
    print(f"  attention_kernel blocks an SM by head dim: {occupancy}")
    if not all(occupancy.values()):
        raise AssertionError(f"flash_attention: an instantiation fits no "
                             f"SM: {occupancy}")
    errs = []

    def case(b, hq, hkv, hd, tq, tk):
        q = torch.randn(b, tq, hq, hd, generator=g, device=dev)
        k, v = (torch.randn(b, tk, hkv, hd, generator=g, device=dev)
                for _ in range(2))
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def check(label, q, k, v, **kw):
        got = flash_attention(q, k, v, **kw)
        compare(f"flash_attention {label}", got,
                flash_attention_ref(q, k, v, **kw), errs, tol=ATTN_TOL)
        return got

    def repeat(label, got, q, k, v, **kw):
        if not torch.equal(flash_attention(q, k, v, **kw), got):
            raise AssertionError(f"flash_attention {label}: two calls on "
                                 f"the same inputs differ")

    for group in range(1, 5):
        for hd, t in ((16, 21), (32, 130), (64, 300), (128, 200), (256, 77),
                      (256, 333)):
            q, k, v = case(2, 2 * group, 2, hd, t, t)
            for causal, window, cap in ((True, 0, 0.0), (False, 0, 0.0),
                                        (True, 16, 0.0), (True, 16, 50.0),
                                        (False, 9, 30.0), (True, 70, 50.0)):
                kw = dict(causal=causal, window=window, cap=cap)
                got = check(f"G={group} hd={hd} T={t} causal={causal} "
                            f"window={window} cap={cap}", q, k, v, **kw)
            repeat(f"G={group} hd={hd} T={t}", got, q, k, v, **kw)
        q, k, v = case(1, 2 * group, 2, 64, 60, 20)
        check(f"G={group} Tq=60 Tk=20 window=8 (rows >= 27: no key)", q, k,
              v, causal=True, window=8, cap=30.0)
        hd = HEAD_DIMS[group]
        q, k, v = case(1, 2 * group, 2, hd, 150, 70)
        check(f"G={group} hd={hd} Tq=150 Tk=70 window=30 (rows >= 99: no "
              f"key)", q, k, v, causal=True, window=30, cap=0.0)
        q, k, v = case(2, 2 * group, 2, hd, 45, 130)
        for causal in (True, False):
            check(f"G={group} hd={hd} Tq=45 Tk=130 causal={causal}", q, k, v,
                  causal=causal, window=0, cap=20.0)

    shapes = {"llama3.2-1b": (1, 32, 8, 64, 1024, dict(causal=True)),
              "gemma2-2b local": (1, 8, 4, 256, 6000,
                                  dict(causal=True, window=4096, cap=50.0)),
              "gemma2-2b global": (1, 8, 4, 256, 6000,
                                   dict(causal=True, cap=50.0))}
    cases = {}
    for label, (b, hq, hkv, hd, t, kw) in shapes.items():
        q, k, v = case(b, hq, hkv, hd, t, t)
        got = check(f"{label} B={b} T={t} Hq={hq} Hkv={hkv} hd={hd} {kw}",
                    q, k, v, **kw)
        repeat(label, got, q, k, v, **kw)
        del got
        if "cap" not in kw:
            def library(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
        else:
            def library(q=q, k=k, v=v, mask=flex_mask(
                    t, t, causal=kw["causal"], window=kw.get("window", 0))):
                return flex_softcap(q, k, v, mask, kw["cap"])
        lib_err = (library() - flash_attention_ref(q, k, v, **kw)).abs().max()
        print(f"  library call at {label}: max|err| {lib_err.item():.3e} "
              f"against the plain version (not held)")
        cases[label] = dict(
            unit=f"one prefill attention layer of {label}: B={b}, T={t}, "
                 f"Hq {hq}, Hkv {hkv}, hd {hd}, {kw}",
            **timings(lambda: flash_attention(q, k, v, **kw),
                      lambda: flash_attention_ref(q, k, v, **kw), library),
            bound=attention_bound(b, hq, hkv, hd, t, t, kw["causal"],
                                  kw.get("window", 0)))
        r = cases[label]
        print(f"  flash_attention {label}: kernel {r['ms']:.4f} "
              f"[{r['eager_ms']['ms']:.4f}] ms, plain {r['plain_ms']:.4f} ms, "
              f"library {fmt_ms(r['library_ms'])} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
        del q, k, v
    head = cases["gemma2-2b global"]
    return dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:67",
        max_abs_err=max(errs),
        **{key: head[key] for key in ("unit", "ms", "plain_ms", "library_ms",
                                      "eager_ms", "bound")},
        library_calls="compiled flex_attention(softcap score_mod, causal / "
                      "window block mask, enable_gqa), float32; "
                      "scaled_dot_product_attention(is_causal, enable_gqa) "
                      "at llama3.2-1b's shapes",
        registers=resources, blocks_per_sm=occupancy, cases=cases)


# ---------------------------------------------------------------------------
# whisper's K-FAC training: patch_factor, the cuda-vs-cpu agreement, the
# full-width run through the launcher
# ---------------------------------------------------------------------------

# b, t, c, taps, stride, padding, bias: ragged cases, then whisper-small's
# two conv stems (the last two, timed)
PATCH_CASES = [(2, 21, 13, 3, 1, "SAME", True),
               (1, 131, 8, 4, 1, "VALID", False),
               (2, 31, 8, 3, 2, "SAME", True), (2, 8, 8, 9, 1, "SAME", True),
               (2, 2, 8, 3, 1, "VALID", True),
               (3, 100, 136, 3, 2, "SAME", True),
               (8, 3000, 80, 3, 1, "SAME", True),
               (8, 3000, 768, 3, 2, "SAME", True)]
WHISPER_N = 8 * 64            # the launcher's global N: B·T decoder tokens


def unfold_addmm(x, c, *, taps, stride, padding, has_bias, alpha, beta):
    """The library yardstick: ``unfold`` (im2col) and ``torch.addmm``."""
    from repro_torch.models.conv import conv_pad_amounts
    lo, hi = conv_pad_amounts(x.shape[1], taps, stride, padding)
    p = torch.nn.functional.pad(x, (0, 0, lo, hi)).unfold(1, taps, stride)
    p = p.transpose(-1, -2).reshape(-1, taps * x.shape[-1])
    if has_bias:
        p = torch.cat([p, p.new_ones(p.shape[0], 1)], dim=1)
    return torch.addmm(c, p.T, p, beta=beta, alpha=alpha)


def patch_kernel_row(dev, g) -> dict:
    """patch_factor against its plain version on ragged cases and at
    whisper-small's two conv shapes, at beta = 0 and 0.95 (the
    factor_update rule: within TOL * max|alpha * P̂ᵀP̂|), then timed at the
    two whisper shapes beside the plain version and unfold + addmm."""
    from repro_torch.kernels.gemm_plan import sm_count, triangle_plan
    from repro_torch.kernels.patch_factor import (patch_factor_update,
                                                  patch_factor_update_ref,
                                                  patch_geometry)
    errs, ops = [], []
    for b, t, c, k, s, pad, bias in PATCH_CASES:
        x = torch.randn(b, t, c, generator=g, device=dev)
        d = k * c + int(bias)
        y = torch.tanh(torch.randn(512, d, generator=g, device=dev))
        old = y.T @ y / 512
        kw = dict(taps=k, stride=s, padding=pad, has_bias=bias)
        for e in (0.0, 0.95):
            eps = torch.tensor(e, device=dev)
            a = (1 - eps) / WHISPER_N
            prod = patch_factor_update_ref(x, old, alpha=a, beta=0.0, **kw)
            compare(f"patch_factor x{(b, t, c)} k={k} s={s} {pad} "
                    f"beta={e}",
                    patch_factor_update(x, old, alpha=a, beta=eps, **kw),
                    patch_factor_update_ref(x, old, alpha=a, beta=eps, **kw),
                    errs, scale=max(prod.abs().max().item(), 1e-30))
        if t == 3000:
            ops.append((x, old, kw))
    # one triangle plus a mirror: a C that is not symmetric, so each
    # mirrored entry must take its own C entry (alpha = 1 - eps: an entry
    # read from the wrong side of C stands far above the tolerance), at a
    # ragged case, at d = 65 and 129 (one more than a tile multiple: the
    # bias feature folded into the last tile column) and at conv2
    ge = torch.Generator(device=dev).manual_seed(3)  # g's draws unchanged
    for b, t, c, k, s, pad, bias in [PATCH_CASES[0],
                                      (2, 40, 16, 4, 1, "SAME", True),
                                      (1, 50, 32, 4, 2, "SAME", True),
                                      PATCH_CASES[-1]]:
        x = torch.randn(b, t, c, generator=ge, device=dev)
        d = k * c + int(bias)
        old = torch.randn(d, d, generator=ge, device=dev)
        kw = dict(taps=k, stride=s, padding=pad, has_bias=bias)
        plan = triangle_plan(d, k * c, bias, b * patch_geometry(
            x.shape, k, s, pad)[1], sm_count(0))
        eps = torch.tensor(0.95, device=dev)
        prod = patch_factor_update_ref(x, old, alpha=1 - eps, beta=0.0, **kw)
        compare(f"patch_factor C not symmetric x{(b, t, c)} tile "
                f"{plan.tile} fold {int(plan.fold)} splits {plan.splits}",
                patch_factor_update(x, old, alpha=1 - eps, beta=eps, **kw),
                patch_factor_update_ref(x, old, alpha=1 - eps, beta=eps,
                                        **kw),
                errs, scale=max(prod.abs().max().item(), 1e-30))
        del x, old, prod
    eps = torch.tensor(0.95, device=dev)
    run = lambda f: [f(x, old, alpha=(1 - eps) / WHISPER_N, beta=eps, **kw)
                     for x, old, kw in ops]
    # P̂ᵀP̂ is symmetric, so the function needs only its d(d+1)/2 distinct
    # entries, 2N operations each; the kernel computes one triangle of tiles
    # (the diagonal tiles whole).
    flops = nbytes = full = 0.0
    for x, old, kw in ops:
        n = x.shape[0] * patch_geometry(x.shape, kw["taps"], kw["stride"],
                                        kw["padding"])[1]
        d = old.shape[0]
        flops += float(n) * d * (d + 1)
        full += 2.0 * n * d * d
        nbytes += 4.0 * (x.numel() + 2 * d * d)
    # the library call takes Python scalars: a tensor alpha or beta would
    # make addmm read it on the host
    library = lambda: [unfold_addmm(x, old, alpha=0.05 / WHISPER_N,
                                    beta=0.95, **kw) for x, old, kw in ops]
    return dict(
        source="src/repro_torch/csrc/patch_factor.cu",
        replaces="src/repro/kernels/patch_factor.py:83",
        unit="both conv stems of one whisper-small stats step: x (8, 3000, "
             "80) -> 241², x (8, 3000, 768) s 2 -> 2305²",
        max_abs_err=max(errs),
        library_calls="pad + unfold + cat + addmm",
        **timings(lambda: run(patch_factor_update),
                  lambda: run(patch_factor_update_ref), library),
        bound=bound_ms(flops, nbytes),
        full_product_bound_ms=bound_ms(full, 0.0)[0])


# (n, d): the autoencoder's factor sides at the full batch, and ragged ones
FU_CASES = [(N_ROWS, d) for d in (785, 1001, 1000, 784, 501, 251, 31, 30)
            ] + [(1000, 30)]
# (S, N, d): whisper-small's stacked layers, one launch each: the
# encoder's widths at N = 8 x 1500 and the decoder's d_ff at N = 512
FU_WHISPER = [(12, 12000, 768), (12, 512, 3072), (12, 12000, 3072)]


def ptxas_resources(log: str, kernel: str) -> list:
    """(template arguments, registers, spill store bytes, spill load bytes)
    of each instantiation of ``kernel`` in an ``nvcc -Xptxas -v`` log, the
    arguments as ptxas mangles them (``ILi128ELb1ELb0E``: 128, true,
    false)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                args = re.search(kernel + r"(I.*?E)E", name)
                out.append([args.group(1) if args else name, None, None,
                            None])
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            out[-1][2:] = [int(st), int(ld)]
        elif name and "registers" in line:
            out[-1][1] = int(re.search(r"Used (\d+) registers",
                                       line).group(1))
    return [tuple(r) for r in out]


def ax_plan(m: int, n: int, k: int) -> str:
    """axpy_momentum's launch for (m, k) @ (k, n), row-major and aligned:
    the 64 tile, K whole, and the copy widths of gemm_plan.dense_vec16 /
    dense_rows16, as "m x n x k: 64/1, B 16|4 B, A rows|k-major"."""
    return (f"{m}x{n}x{k}: 64/1, B {16 if n % 4 == 0 else 4} B, "
            f"A {'rows' if k % 4 == 0 else 'k-major'}")


def mm_plan(batch: int, m: int, n: int, k: int) -> str:
    """matmul's plan for ([batch,] m, k) @ (k, n) on this card (row-major,
    aligned operands), as "batch x m x n x k: tile/splits"."""
    from repro_torch.kernels import gemm_plan
    tiles = gemm_plan.MATMUL_TILES if n % 4 == 0 else (gemm_plan.DENSE_TILE,)
    p = gemm_plan.dense_plan(batch, m, n, k, gemm_plan.sm_count(0), tiles)
    return f"{batch}x{m}x{n}x{k}: {p.tile}/{p.splits}"


@contextlib.contextmanager
def forced(name: str, plan_of):
    """Make ``gemm_plan.<name>`` return ``plan_of(*args)`` inside."""
    from repro_torch.kernels import gemm_plan
    keep = getattr(gemm_plan, name)
    setattr(gemm_plan, name, plan_of)
    try:
        yield
    finally:
        setattr(gemm_plan, name, keep)


def factor_update_row(dev, randn, spd, sides, log) -> dict:
    """factor_update against its plain version, held to TOL * max|alpha *
    XᵀX| (beta * C would otherwise dwarf an error in the product): the
    autoencoder's sides and ragged ones at beta = 0 (the first step) and
    0.95; whisper-small's three stacked shapes; a C that is not symmetric
    (alpha = 1 - eps, so that a mirrored entry read from the wrong side of
    C stands far above the tolerance), unbatched and batched; each tile and
    a forced split at a ragged shape; 4-byte copies of an x with d % 4 == 0
    off a 16-byte boundary.  Then timed at the autoencoder's 16 sides beside
    addmm and at whisper's three stacked shapes beside baddbmm.  Fails if
    a kernel instantiation spills."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.factor_update import (factor_update,
                                                   factor_update_ref, vec16)
    resources = ptxas_resources(log, "factor_update_kernel")
    for args, regs, st, ld in resources:
        print(f"  factor_update_kernel<{args}>: {regs} registers, spill "
              f"stores {st} B, loads {ld} B")
    if any(st or ld for _, _, st, ld in resources):
        raise AssertionError(f"factor_update spills: {resources}")
    errs = []

    def check(label, x, c, a, b):
        prod = factor_update_ref(x, c, alpha=a, beta=0.0)
        compare(f"factor_update {label}", factor_update(x, c, alpha=a, beta=b),
                factor_update_ref(x, c, alpha=a, beta=b), errs,
                scale=prod.abs().max().item())

    # alpha/beta as device scalars, as the main path passes them
    for n, d in FU_CASES:
        x, c = torch.tanh(randn(n, d)), spd(d, 512)
        for e in (0.0, 0.95):
            eps = torch.tensor(e, device=dev)
            check(f"X({n},{d}) beta={e}", x, c, (1 - eps) / n, eps)
    xs = [torch.tanh(randn(N_ROWS, d)) for d in sides]
    cs = [spd(d, 512) for d in sides]
    eps = torch.tensor(0.95, device=dev)
    fu = lambda f: [f(x, c, alpha=(1 - eps) / N_ROWS, beta=eps)
                    for x, c in zip(xs, cs)]
    # XᵀX is symmetric, so the function needs only its d(d+1)/2 distinct
    # entries, 2N operations each; the kernel computes one triangle of tiles
    # (the diagonal tiles whole).
    row = dict(
        source="src/repro_torch/csrc/factor_update.cu",
        replaces="src/repro/kernels/factor_update.py:41",
        unit=f"all 16 factor sides of one step, X ({N_ROWS}, d)",
        library_calls="addmm; whisper-small: baddbmm",
        registers=resources,
        **timings(lambda: fu(factor_update), lambda: fu(factor_update_ref),
                  lambda: [torch.addmm(c, x.T, x, beta=0.95,
                                       alpha=0.05 / N_ROWS)
                           for x, c in zip(xs, cs)]),
        bound=bound_ms(float(N_ROWS) * sum(d * (d + 1) for d in sides),
                       4.0 * sum(N_ROWS * d + 2 * d * d for d in sides)))
    del xs, cs

    ops, flops, nbytes = [], 0.0, 0.0
    for s_, n, d in FU_WHISPER:
        x = torch.tanh(randn(s_, n, d))
        c = torch.stack([spd(d, 512)] * s_)
        check(f"batched X({s_},{n},{d})", x, c, (1 - eps) / n, eps)
        ops.append((x, c))
        flops += float(s_) * n * d * (d + 1)
        nbytes += 4.0 * s_ * (n * d + 2 * d * d)
    run = lambda f: [f(x, c, alpha=(1 - eps) / x.shape[1], beta=eps)
                     for x, c in ops]
    # the library call takes Python scalars: a tensor alpha or beta would
    # make baddbmm read it on the host
    row["cases"] = {"whisper-small": dict(
        unit="whisper-small's stacked factor sides of one stats step: X "
             + ", ".join(f"({s_}, {n}, {d})" for s_, n, d in FU_WHISPER),
        **timings(lambda: run(factor_update), lambda: run(factor_update_ref),
                  lambda: [torch.baddbmm(c, x.transpose(1, 2), x, beta=0.95,
                                         alpha=0.05 / x.shape[1])
                           for x, c in ops]),
        bound=bound_ms(flops, nbytes))}
    del ops, x, c

    # one triangle plus a mirror, each tile, a forced split, both copy
    # widths; a second generator leaves randn's draws as they were
    ge = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *s: torch.randn(*s, generator=ge, device=dev)
    a = 1 - eps
    for shape in [(N_ROWS, 1001), (N_ROWS, 1000), (1000, 30), (777, 251),
                  (3, 100, 33), (2, 512, 768)]:
        x, d = torch.tanh(rnd(*shape)), shape[-1]
        c = rnd(*shape[:-2], d, d)
        check(f"C not symmetric X{shape} vec {int(vec16(x))}", x, c, a, eps)
    n, d = 777, 251
    x, c = torch.tanh(rnd(n, d)), rnd(d, d)
    for tile in gemm_plan.TILES:
        for splits in (1, 4):
            chunk, used = gemm_plan.chunks(n, splits)
            plan = gemm_plan.Plan(tile, -(-d // tile), 0, chunk, used)
            with forced("triangle_plan", lambda *_, plan=plan: plan):
                check(f"X({n},{d}) C not symmetric, forced tile {tile} "
                      f"splits {used}", x, c, a, eps)
    base = torch.tanh(rnd(N_ROWS * 1000 + 1))
    x = base[1:].view(N_ROWS, 1000)   # 4 bytes off a 16-byte boundary
    assert not vec16(x)
    check(f"X({N_ROWS},1000) off a 16-byte boundary, vec 0", x,
          spd(1000, 512), (1 - eps) / N_ROWS, eps)
    del base, x, c
    row["max_abs_err"] = max(errs)
    return row



def agree_lm(arch: str, steps: int = 4, mfd: int = 8192, **kw) -> list:
    """Reduced ``arch`` (whisper-small, smollm-135m, llama3.2-1b or
    gemma2-2b), ``steps`` K-FAC steps of the launcher's setup on the card
    and on the CPU (plain versions), same weights and uniforms: losses
    within rtol 1e-3.  ``mfd``: the ``max_factor_dim`` that sets the
    metas' factor layouts (below the reduced widths: block sides); ``kw``:
    other ``KFACConfig`` fields (eigen mode, the fused chain,
    ``fused_stats``)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import KFACConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import _ArchData
    from repro_torch.models.lm import LM
    from repro_torch.optimizers.kfac import kfac
    from repro_torch.training.trainer import Trainer

    cfg = get_reduced_config(arch)
    kcfg = KFACConfig(lambda_init=10.0, t3=5, max_factor_dim=mfd, **kw)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    hist = {}
    for where in ("cuda", "cpu"):
        lm = LM(cfg, kcfg, device=where)
        data = _ArchData(cfg, SyntheticLMData(cfg.vocab_size, 64, 8,
                                              device=where))
        noise = lambda step, shape, where=where: torch.rand(
            shape, generator=torch.Generator().manual_seed(step)).to(where)
        tr = Trainer(lm, kfac(lm, kcfg, device=where),
                     TrainConfig(seed=0, log_every=10 ** 9), noise=noise,
                     device=where)
        hist[where] = [h["loss"] for h in tr.fit(
            to_device(params, where), data, steps=steps,
            log=lambda *_: None)["history"]]
    tag = " ".join([arch] + ([f"max_factor_dim {mfd}"] if mfd != 8192
                             else []) + [f"{k}={v}" for k, v in kw.items()])
    print(f"[agree:{tag}] reduced {arch} losses cuda {hist['cuda']}")
    print(f"        plain versions on the cpu {' ' * len(tag)}{hist['cpu']}")
    for a, b in zip(hist["cuda"], hist["cpu"]):
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"{arch}: cuda path {a} vs cpu path {b}")
    return hist["cuda"]


W_STEPS = 10


def whisper_launches(stop: int, start: int = 0) -> dict:
    """The launch counts of launcher steps ``start`` to ``stop`` of
    full-width whisper-small at the launcher's defaults (``lm_launches``;
    the warmup re-armed at ``start``): patch_factor on the two conv stems
    and factor_update on the 38 other factor sides a step, precondition on
    the 20 Kronecker blocks a step, ns_step on the 42 full factors 12 times
    a refresh (the embedding's Ā and the head's Ḡ are diagonal)."""
    from repro_torch.configs.base import KFACConfig
    return lm_launches(KFACConfig(lambda_init=10.0, t3=5),
                       decoder_metas("whisper-small"), stop, start)


def whisper_main(steps: int, ckpt: str) -> dict:
    """``Trainer.fit`` of full-width whisper-small through
    ``launch/train.py``'s ``main`` with ``--ckpt_dir ckpt``, the launch
    counters zeroed just before and read just after
    (``whisper_launches``): the checkpoint at step ``steps``, written after
    the timed steps, its bytes, host-copy ms and write seconds."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    K.reset_launches()
    t0 = time.perf_counter()
    ms, seen = [], {}
    with launcher_checkpointer(seen):
        res = train.main(["--arch", "whisper-small", "--steps", str(steps),
                          "--ckpt_dir", ckpt],
                         log=lambda msg: print(f"  {msg}"),
                         wrap_opt=lambda opt: timed(opt, ms))
    torch.cuda.synchronize()
    wall_ckpt = time.perf_counter() - t0
    launches = K.launches()
    peak = torch.cuda.max_memory_allocated()
    ck = seen["ckpt"]
    # the checkpoint's blocking host copy and the write that fit waits for,
    # taken out: wall_s keeps the meaning it had before the checkpoint
    ckpt_s = ck.stats["save_host_ms"] / 1e3 + ck.stats["write_s"]
    wall = wall_ckpt - ckpt_s
    refresh = [i for i in range(steps) if i < 3 or i % 5 == 0]
    want = whisper_launches(steps)
    losses = [h["loss"] for h in res["history"]]
    plain = sorted(t for i, t in enumerate(ms) if i not in refresh)
    print(f"[main:whisper] full-width whisper-small "
          f"({LM(get_config('whisper-small'), device='cuda').n_params():,} "
          f"params), batch 8, seq 64, {steps} steps in {wall:.1f} s "
          f"({wall_ckpt:.1f} s with the checkpoint's {ckpt_s:.1f} s)")
    print(f"  per-step ms: {[round(t, 1) for t in ms]}")
    print(f"  plain-step median {plain[len(plain) // 2]:.1f} ms; refresh "
          f"steps {[round(ms[i], 1) for i in refresh]} ms (step 0 includes "
          f"the first calls' set-up); peak memory {peak / 2 ** 20:.1f} MiB, "
          f"of which {resident / 2 ** 20:.1f} MiB was allocated before")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    print(f"  launches: {launches}")
    if (not all(math.isfinite(v) for v in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"whisper: loss not finite and falling: "
                             f"{losses}")
    if launches != want:
        raise AssertionError(f"whisper: launch counts {launches}, expected "
                             f"{want}")
    out = {"steps": steps, "n_tokens": 8 * 64, "step_ms": ms,
           "plain_step_ms_median": plain[len(plain) // 2],
           "refresh_step_ms": {i: ms[i] for i in refresh},
           "peak_mem_bytes": peak, "resident_bytes_before": resident,
           "losses": losses, "launches": launches, "wall_s": wall,
           "wall_with_ckpt_s": wall_ckpt}
    npz = Path(ckpt) / f"step_{steps:08d}" / "arrays.npz"
    if ck.all_steps() != [steps]:
        raise AssertionError(f"whisper: checkpoints {ck.all_steps()}")
    out["ckpt"] = dict(ck.stats, npz_bytes=npz.stat().st_size)
    print(f"[ckpt:whisper] checkpoint at step {steps}: "
          f"{ck.stats['bytes']:,} bytes ({out['ckpt']['npz_bytes']:,} in "
          f"arrays.npz); save host copy {ck.stats['save_host_ms']:.1f} ms, "
          f"write {ck.stats['write_s']:.2f} s on the thread (after the "
          f"timed steps; not in the {wall:.1f} s above)")
    del res
    torch.cuda.empty_cache()
    return out


def profile_whisper() -> dict:
    """Where whisper's time goes: steps 3 and 4 (a plain step and a lambda
    step) of a second run of the launcher's setup under
    ``torch.profiler``: device busy share and the busiest kernels.  Run
    with the other profiles, after every timed path."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import KFACConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.optimizers.kfac import kfac
    from repro_torch.training.trainer import Trainer

    cfg = get_config("whisper-small")
    kcfg = KFACConfig(lambda_init=10.0, t3=5)
    lm = LM(cfg, device="cuda")
    opt = kfac(lm, kcfg, device="cuda")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def update(grads, state, params, batch, rng, _update=opt.update):
        step = int(state.step)
        if step == 3:
            torch.cuda.synchronize()
            prof.__enter__()
            window["t0"] = time.perf_counter()
        out_ = _update(grads, state, params, batch, rng)
        if step == 4:
            torch.cuda.synchronize()
            window["ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.__exit__(None, None, None)
        return out_

    data = train._ArchData(cfg, SyntheticLMData(cfg.vocab_size, 64, 8,
                                                device="cuda"))
    Trainer(lm, dataclasses.replace(opt, update=update),
            TrainConfig(steps=5, log_every=10 ** 9), device="cuda").fit(
        lm.init_params(torch.Generator(device="cuda").manual_seed(0)),
        data, steps=5, log=lambda *_: None)
    print(f"[profile:whisper] steps 3 and 4 (plain, lambda) in "
          f"{window['ms']:.1f} ms; busiest kernels:")
    busy_ms, top = device_kernels(prof)
    fu = [e for e in _device_events(prof)
          if "factor_update_kernel" in e.key]
    fu_ms = sum(_device_us(e) for e in fu) / 1e3
    fu_n = sum(e.count for e in fu)
    print(f"  device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / window['ms']:.1f}%); factor_update_kernel "
          f"{fu_ms:.1f} ms in {fu_n} launches (split partials' sums, shared "
          f"with patch_factor, not included)")
    torch.cuda.empty_cache()
    return {"wall_ms": window["ms"], "device_busy_ms": busy_ms, "top": top,
            "factor_update_ms": fu_ms, "factor_update_launches": fu_n}


def to_device(params, dev):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(dev), params)


def agree_serving(arch) -> dict:
    """Reduced ``arch`` on the card and on the CPU (plain versions) from the
    same weights.  Held to ``SERVE_TOL`` · max|cpu logits|: the prefill
    logits of two prompts, and four paged decode steps' logits, each step
    taken by both devices from the same bf16 cache (the CPU's, copied to
    the card before every step; only the step's own new K/V row is
    rounded to bf16 by each device).  The engine's greedy tokens of 7
    requests on the card must equal those on the CPU, or differ only at a
    proven near tie: at the first differing token both devices' logits,
    recomputed by a prefill of the same tokens, agree to ``SERVE_TOL`` ·
    max|logits|, and the CPU's top-2 margin lies below that.  (On the card
    the prefill runs the flash_attention kernel and on the CPU its plain
    version, so their bf16 caches may differ by an ulp, as above.)"""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.lm import LM
    from repro_torch.serving.cache import PagedKVCache
    from repro_torch.serving.server import Engine, Request

    cfg = get_reduced_config(arch)
    lms = {dev: LM(cfg, device=dev) for dev in ("cpu", "cuda")}
    params = {"cpu": lms["cpu"].init_params(torch.Generator().manual_seed(0))}
    params["cuda"] = to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (21, 5)]
    steps = [rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
             for _ in range(4)]
    kv = PagedKVCache(lms["cpu"], batch_slots=2, max_len=32, page_size=4)
    table = torch.arange(1, 1 + 2 * kv.max_blocks,
                         dtype=torch.int32).reshape(2, kv.max_blocks)
    pools = kv.init_pools()
    errs = []

    def held(got, want):
        errs.append((got.cpu() - want).abs().max().item()
                    / want.abs().max().item())

    for row, prompt in enumerate(prompts):
        toks = {"tokens": torch.tensor([prompt])}
        lg_c, cache = lms["cpu"].prefill(params["cpu"], toks)
        lg_g, _ = lms["cuda"].prefill(params["cuda"], toks)
        held(lg_g, lg_c)
        kv.write_prefill(pools, table[row].tolist(), cache, len(prompt))
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for toks in steps:
        shared = to_device(pools, "cuda")
        lg_g, _ = lms["cuda"].decode_step(params["cuda"], shared,
                                          torch.from_numpy(toks), pos,
                                          page_table=table)
        lg_c, pools = lms["cpu"].decode_step(params["cpu"], pools,
                                             torch.from_numpy(toks), pos,
                                             page_table=table)
        held(lg_g, lg_c)
        pos = pos + 1
    err = max(errs)
    spec = [(0, 3, 4), (1, 20, 9), (2, 4, 2), (3, 8, 5), (4, 3, 7),
            (5, 6, 3), (6, 17, 6)]
    tokens, prompts = {}, {}
    for dev in ("cuda", "cpu"):
        reqs = [Request(uid=u, prompt=[(7 * u + j) % cfg.vocab_size
                                       for j in range(tp)], max_new=mn)
                for u, tp, mn in spec]
        Engine(lms[dev], params[dev], batch_slots=3, max_len=32).run(reqs)
        tokens[dev] = [r.out for r in reqs]
        prompts[dev] = [r.prompt for r in reqs]
    same = tokens["cuda"] == tokens["cpu"]
    print(f"[agree:serve:{arch}] reduced: prefill and 4 paged decode steps "
          f"from a shared cache, max|cuda - cpu| / max|cpu| logits "
          f"{err:.3e} (per call: {[f'{e:.2e}' for e in errs]}); greedy "
          f"tokens of {len(spec)} requests equal: {same}")
    if not (math.isfinite(err) and err <= SERVE_TOL):
        raise AssertionError(f"{arch}: cuda logits differ from cpu ({err})")
    ties = []
    for prompt, a, b in zip(prompts["cpu"], tokens["cuda"], tokens["cpu"]):
        if a == b:
            continue
        i = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        toks = {"tokens": torch.tensor([prompt + b[:i]])}
        lg_c = lms["cpu"].prefill(params["cpu"], toks)[0][0, -1]
        lg_g = lms["cuda"].prefill(params["cuda"], toks)[0][0, -1].cpu()
        scale = lg_c.abs().max().item()
        top2 = torch.topk(lg_c, 2).values
        margin = (top2[0] - top2[1]).item()
        rel = (lg_g - lg_c).abs().max().item() / scale
        print(f"  streams differ at token {i}: logits rel err {rel:.3e}, "
              f"cpu top-2 margin {margin / scale:.3e} of max|logits|")
        if not (rel <= SERVE_TOL and margin < SERVE_TOL * scale):
            raise AssertionError(f"{arch}: cuda tokens {a} vs cpu {b} differ "
                                 f"away from a near tie")
        ties.append({"token": i, "rel_err": rel, "margin": margin / scale})
    return {"max_rel_err": err, "rel_errs": errs, "tokens_equal": same,
            "near_ties": ties}


def serve_requests(cfg, lengths, max_new, seed=0):
    from repro_torch.serving.server import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(n)).tolist(),
                    max_new=max_new) for i, n in enumerate(lengths)]


def serve_run(label, lm, params, reqs, route="paged", **engine_kw):
    """One ``Engine.run`` with the launch counters zeroed just before and
    read just after: every decode step must launch the route's kernel once
    per layer, every prefill call (one per group of equal prompt length,
    replays after preemption included) flash_attention once per layer, and
    nothing else may launch.  Times are the engine's own (``RunReport``);
    tokens/s is over the run's host-clock wall time."""
    from repro_torch import kernels as K
    from repro_torch.serving.server import Engine

    eng = Engine(lm, params, decode_route=route, **engine_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    K.reset_launches()
    t0 = time.perf_counter()
    rep = eng.run(reqs, max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches()
    peak = torch.cuda.max_memory_allocated()
    kernel = "flash_decode_paged" if route == "paged" else "flash_decode"
    want = {name: 0 for name in K.WRAPPERS}
    want[kernel] = lm.cfg.n_layers * rep.decode_steps
    want["flash_attention"] = lm.cfg.n_layers * len(rep.prefill_ms)
    n_tok = sum(len(r.out) for r in reqs)
    vocab = lm.cfg.vocab_size
    ok_tokens = all(r.done and len(r.out) == r.max_new
                    and all(0 <= t < vocab for t in r.out) for r in reqs)
    srt = sorted(rep.decode_step_ms)
    out = {
        "route": route, "requests": len(reqs),
        "prompt_lengths": [len(r.prompt) for r in reqs],
        "max_new": reqs[0].max_new, "wall_s": wall, "tokens": n_tok,
        "tokens_per_s": n_tok / wall, "decode_steps": rep.decode_steps,
        "decode_step_ms_median": srt[len(srt) // 2],
        "decode_step_ms_min": srt[0], "decode_step_ms_max": srt[-1],
        "prefills": len(rep.prefill_ms), "prefill_ms_total":
            sum(rep.prefill_ms), "prefill_ms": rep.prefill_ms,
        "ttft_p50_ms": rep.ttft_p50_ms, "ttft_p99_ms": rep.ttft_p99_ms,
        "token_gap_p50_ms": rep.decode_p50_ms,
        "token_gap_p99_ms": rep.decode_p99_ms,
        "preemptions": rep.preemptions, "evicted_pages": rep.evictions,
        "num_pages": eng.kv.num_pages, "peak_mem_bytes": peak,
        "resident_bytes_before": resident, "launches": launches}
    print(f"[serve:{label}] {len(reqs)} requests, {route} route: "
          f"{rep.decode_steps} decode steps in {wall:.3f} s, {n_tok} tokens, "
          f"{out['tokens_per_s']:.1f} tokens/s")
    print(f"  decode step ms (host clock, ends in the logits copy): median "
          f"{out['decode_step_ms_median']:.3f}, min {srt[0]:.3f}, max "
          f"{srt[-1]:.3f}; {len(rep.prefill_ms)} prefills "
          f"{sum(rep.prefill_ms):.1f} ms in all")
    print(f"  TTFT p50 {rep.ttft_p50_ms:.1f} ms, p99 {rep.ttft_p99_ms:.1f} "
          f"ms; token gap p50 {rep.decode_p50_ms:.3f} ms, p99 "
          f"{rep.decode_p99_ms:.3f} ms; preemptions {rep.preemptions}, "
          f"evicted pages {rep.evictions} of {eng.kv.num_pages}; peak "
          f"memory {peak / 2 ** 20:.1f} MiB ({resident / 2 ** 20:.1f} MiB "
          f"before the run)")
    print(f"  launches: {launches}")
    if not ok_tokens:
        raise AssertionError(f"{label}: a request did not finish with "
                             f"max_new tokens in the vocabulary")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, expected "
                             f"{want}")
    return out, [list(r.out) for r in reqs]


def profile_serving(label, lm, params, reqs, profile_prefill=False,
                    **engine_kw) -> dict:
    """Where the time goes: the requests admitted by one ``step_once``
    (their prefills, and with ``profile_prefill`` under ``torch.profiler``
    too), then ten ``step_once`` calls, each one batched decode step plus
    sampling, under ``torch.profiler``: device busy share and device time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.server import Engine

    def profiled(fn, steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    eng = Engine(lm, params, **engine_kw)
    for r in reqs:
        eng.submit(r)
    out = {}
    if profile_prefill:
        prof, wall_ms = profiled(eng.step_once, 1)
        print(f"[profile:{label}] admission of {len(reqs)} requests "
              f"(prompts of {sum(len(r.prompt) for r in reqs)} tokens) and "
              f"one decode step in {wall_ms:.1f} ms under torch.profiler; "
              f"busiest kernels:")
        busy_ms, top = device_kernels(prof)
        print(f"  device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%)")
        out["prefill"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                          "top_kernels": top}
    else:
        eng.step_once()
    if eng.sched.queue:
        raise AssertionError("profile: not every request was admitted")
    steps = 10
    prof, wall_ms = profiled(eng.step_once, steps)
    print(f"[profile:{label}] {steps} decode steps of {len(reqs)} rows in "
          f"{wall_ms:.1f} ms under torch.profiler ({wall_ms / steps:.3f} ms "
          f"a step); busiest kernels:")
    busy_ms, top = device_kernels(prof)
    print(f"  device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    out.update({"steps": steps, "wall_ms": wall_ms,
                "device_busy_ms": busy_ms, "top_kernels": top})
    return out


def ae_paths() -> dict:
    """The autoencoder's four K-FAC paths (phase 5)."""
    from repro_torch.configs.base import KFACConfig
    base = dict(lambda_init=3.0, t3=5, eta=1e-5)
    return {
        "blkdiag": KFACConfig(inv_mode="blkdiag", inverse_method="ns",
                              **base),
        "eigen": KFACConfig(inv_mode="eigen", **base),
        "fused": KFACConfig(inv_mode="blkdiag", inverse_method="ns",
                            use_rescale=False, fixed_lr=0.02,
                            fixed_momentum=0.9, kl_clip=1e-3, **base),
        "tridiag": KFACConfig(inv_mode="tridiag", inverse_method="ns",
                              **base),
    }


def agree_paths() -> dict:
    """Phase 4's paths: phase 5's, and tridiag on the fused chain."""
    paths = ae_paths()
    paths["tridiag_fused"] = dataclasses.replace(paths["fused"],
                                                 inv_mode="tridiag")
    return paths


def modes_paths() -> dict:
    """The modes phase's autoencoder paths, label -> (KFACConfig, loss):
    phase 5's configurations with one mode each (τ1 = 1/8: statistics on
    1024 of the 8192 rows)."""
    paths = ae_paths()
    rep, blk = dataclasses.replace, paths["blkdiag"]
    return {
        "tau1": (rep(blk, tau1=1 / 8), "bernoulli"),
        "stats_period2": (rep(blk, stats_period=2), "bernoulli"),
        "staggered": (rep(blk, refresh_mode="staggered"), "bernoulli"),
        "staggered_eigen": (rep(paths["eigen"], refresh_mode="staggered"),
                            "bernoulli"),
        "staggered_tridiag": (rep(paths["tridiag"],
                                  refresh_mode="staggered"), "bernoulli"),
        "gaussian": (blk, "gaussian"),
    }


def all_paths() -> dict:
    """Every full-width autoencoder path, label -> (KFACConfig, loss)."""
    return {**{label: (cfg, "bernoulli")
               for label, cfg in ae_paths().items()}, **modes_paths()}


def agree_run(tag: str, what: str, build, cfg, family: str) -> list:
    """6 K-FAC steps of one path on the card and on the CPU (plain
    versions), same weights and uniforms: losses within rtol 1e-3.
    ``build(where)`` gives the model, its weights and its data on
    ``where``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optimizers.kfac import kfac
    from repro_torch.training.trainer import Trainer
    hist = {}
    for where in ("cuda", "cpu"):
        model, params, data = build(where)
        noise = lambda step, shape, where=where: torch.rand(
            shape, generator=torch.Generator().manual_seed(step)).to(where)
        tr = Trainer(model, kfac(model, cfg, family=family, device=where),
                     TrainConfig(seed=0, log_every=10 ** 9), noise=noise,
                     device=where)
        hist[where] = [h["loss"] for h in tr.fit(
            params, data, steps=6, log=lambda *_: None)["history"]]
    print(f"[{tag}] {what} losses cuda {hist['cuda']}")
    print(f"        plain versions on the cpu    {hist['cpu']}")
    for a, b in zip(hist["cuda"], hist["cpu"]):
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"{tag}: cuda path {a} vs cpu path {b}")
    return hist["cuda"]


def agree_ae(label: str, cfg, loss: str) -> list:
    """The reduced autoencoder (64-32-16-8 mirrored, N = 256) for 6 K-FAC
    steps of one path on the card and on the CPU (``agree_run``)."""
    from repro_torch.configs.autoencoder import reduced
    from repro_torch.data.pipeline import SyntheticAutoencoderData
    from repro_torch.models.mlp import MLP, autoencoder_dims
    small = autoencoder_dims(reduced())

    def build(where):
        mlp = MLP(small, loss=loss, device=where)
        return (mlp, mlp.init_params(torch.Generator().manual_seed(0)),
                SyntheticAutoencoderData(small[0], 8, 256, seed=7,
                                         device=where))

    return agree_run(f"agree:{label}", "reduced autoencoder", build, cfg,
                     loss)


def ae_model():
    """The full-width autoencoder, its weights from seed 0 and its N = 8192
    synthetic batch, on the card."""
    from repro_torch.configs.autoencoder import CONFIG
    from repro_torch.data.pipeline import SyntheticAutoencoderData
    from repro_torch.models.mlp import MLP, autoencoder_dims
    dims = autoencoder_dims(CONFIG)
    mlp = MLP(dims, device="cuda")
    params = mlp.init_params(torch.Generator().manual_seed(0))
    data = SyntheticAutoencoderData(dims[0], 8, N_ROWS, seed=7,
                                    device="cuda")
    return mlp, params, data


# schedule of 25 steps: refreshes at steps 0, 1, 2 (warmup), 5, 10, 15 (T3)
# and the gamma sweep at 20 (``ae_launches`` counts the launches)
AE_STEPS, AE_REFRESH, AE_SWEEP = 25, (1, 2, 5, 10, 15), 20


def staggered_ns(cfg, steps: int) -> int:
    """ns_step launches of ``steps`` staggered steps: every factor side at
    ``ns_iters`` in the three warmup refreshes and the γ sweeps, and on
    every other step the two sides of each layer of the engine's group
    ``step % T3`` (``stagger_groups()``) at ``ns_hot_iters``."""
    from repro_torch.configs.autoencoder import CONFIG
    from repro_torch.models.mlp import MLP, autoencoder_dims
    from repro_torch.optimizers.kfac import KFACEngine
    groups = KFACEngine(MLP(autoencoder_dims(CONFIG), device="cpu"), cfg,
                        family="bernoulli", device="cpu").stagger_groups()
    n = 0
    for step in range(steps):
        if step < 3 or step % cfg.t2 == 0:
            n += 16 * cfg.ns_iters
        else:
            n += 2 * len(groups[step % cfg.t3]) * cfg.ns_hot_iters
    return n


def ae_launches(label: str, stop: int, start: int = 0) -> dict:
    """The launch counts of a full-width autoencoder path's steps ``start``
    to ``stop`` (``kfac_launches`` over its 8 layers).  The modes: τ1 and
    the Gaussian loss launch what blkdiag does (the sub-batch changes the
    rows, not the launches); ``stats_period=2`` updates the factors on the
    even steps only; the staggered paths launch ns_step as
    ``staggered_ns`` counts (eigen: no ns_step)."""
    cfg = all_paths().get(label, (ae_paths()["blkdiag"],))[0]
    ns = None
    if cfg.refresh_mode == "staggered":
        if start:
            raise ValueError("the staggered schedule is counted from step 0")
        ns = staggered_ns(cfg, stop)
    return kfac_launches(cfg, 8, stop, start, ns=ns)


def kfac_launches(cfg, layers: int, stop: int, start: int = 0,
                  ns=None) -> dict:
    """The launch counts of steps ``start`` to ``stop`` of a K-FAC path on
    a model of ``layers`` tagged full/full layers, the warmup (re-)armed at
    ``start`` as ``KFACPipeline.update`` arms it: refreshes at the first
    three steps and every T3, the γ sweep every T2 (3 candidates, batched
    into the NS launches; one rotate_rescale per candidate and layer in
    eigen mode; the fused path applies candidate 0 only), per step a
    statistics pass on the 2·layers factor sides and an apply on the
    layers.  ``fused_stats`` launches what the two-pass path does: each
    side's contraction is the same one factor_update launch, moved into
    the passes.  blkdiag without momentum launches what blkdiag does: the
    momentum tangent enters only the quadratic model, which runs no kernel
    of ``repro_torch.kernels``.  tridiag launches blkdiag's factor_update
    and NS refresh and nothing else: its cross moments, Ψ/Σ cache and
    apply are plain products and cuSOLVER eigh, as in the reference.
    ``ns``: the path's ns_step count where its schedule is not the serial
    one (``staggered_ns``)."""
    from repro_torch import kernels as K
    steps = range(start, stop)
    sweeps = [s for s in steps if cfg.t2 > 0 and s > 0 and s % cfg.t2 == 0]
    refresh = [s for s in steps if s not in sweeps
               and (s - start < 3 or s % cfg.t3 == 0)]
    n = len(steps)
    if ns is None:
        ns = (len(refresh) + len(sweeps)) * 2 * layers * cfg.ns_iters
    pc = layers * n + 2 * layers * len(sweeps)
    want = dict({name: 0 for name in K.WRAPPERS}, factor_update=2 * layers
                * len([s for s in steps if s % cfg.stats_period == 0]))
    if cfg.inv_mode == "eigen":
        return dict(want, rotate_rescale=pc, matmul_rescale=pc,
                    matmul=3 * pc)
    if cfg.inv_mode == "tridiag":
        return dict(want, ns_step=ns, matmul=2 * ns)
    if not cfg.use_rescale:
        return dict(want, ns_step=ns, precond_momentum=layers * n,
                    axpy_momentum=layers * n, matmul=2 * ns + layers * n)
    return dict(want, precondition=pc, ns_step=ns, matmul=2 * (pc + ns))


def fit_timed(opt, mlp, params, data, steps: int, log_every: int = 5):
    """``Trainer.fit`` of ``opt`` with every update timed (``timed``), the
    launch counters zeroed just before and read just after.  Returns (fit
    result, step ms, launches, peak bytes, bytes allocated before)."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.training.trainer import Trainer
    step_ms = []
    trainer = Trainer(mlp, timed(opt, step_ms),
                      TrainConfig(steps=steps, seed=0, log_every=log_every),
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    K.reset_launches()
    out = trainer.fit(params, data, steps=steps,
                      log=lambda msg: print(f"  {msg}"))
    torch.cuda.synchronize()
    return (out, step_ms, K.launches(), torch.cuda.max_memory_allocated(),
            resident)


def autoencoder_main(label: str, steps: int = AE_STEPS, mlp=None,
                     params=None, data=None, cfg=None) -> dict:
    """``Trainer.fit`` of the full-width autoencoder on one path (phase 5
    or the modes phase, ``all_paths()``; or ``cfg``, a Bernoulli path of
    the "conv" phase), the launch counters zeroed just
    before and read just after: exact counts, the loss finite and falling,
    per-step host times, the largest step after the warmup but the
    sweep's, and peak memory.  ``python3 -c 'import chip_smoke as c;
    c.autoencoder_main("eigen")'`` runs one path alone, in a process of its
    own (the A/B of two checkouts)."""
    from repro_torch.models.mlp import MLP
    from repro_torch.optimizers.kfac import kfac
    if mlp is None:
        mlp, params, data = ae_model()
    if cfg is None:
        cfg, loss = all_paths()[label]
        want = ae_launches(label, steps)
    else:
        loss = "bernoulli"
        want = kfac_launches(cfg, 8, steps)
    if loss != mlp.loss_kind:
        mlp = MLP(mlp.dims, loss=loss, device="cuda")
    out, step_ms, launches, peak, resident = fit_timed(
        kfac(mlp, cfg, family=loss, device="cuda"), mlp, params, data,
        steps)
    losses = [h["loss"] for h in out["history"]]
    srt = sorted(step_ms)
    plain = sorted(t for i, t in enumerate(step_ms)
                   if i not in (0, AE_SWEEP, *AE_REFRESH))
    after = max(t for i, t in enumerate(step_ms) if i >= 3 and i != AE_SWEEP)
    print(f"[main:{label}] full width {mlp.dims}, N={N_ROWS}, {steps} steps")
    print(f"  per-step ms: {[round(t, 3) for t in step_ms]}")
    print(f"  step ms: median {srt[len(srt) // 2]:.3f}, min {srt[0]:.3f}"
          f", max {srt[-1]:.3f}; plain-step median "
          f"{plain[len(plain) // 2]:.3f}; refresh steps "
          f"{[round(step_ms[i], 3) for i in AE_REFRESH]}; sweep step "
          f"{step_ms[AE_SWEEP]:.3f}; largest step after the warmup but the "
          f"sweep's {after:.3f}; peak memory "
          f"{peak / 2 ** 20:.1f} MiB, of which "
          f"{resident / 2 ** 20:.1f} MiB was allocated before the run")
    print(f"  losses: first {losses[0]:.4f}, last {losses[-1]:.4f}")
    print(f"  launches: {launches}")
    if (not all(math.isfinite(v) for v in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"{label}: loss not finite and falling: "
                             f"{losses}")
    clipped = cfg.kl_clip > 0 or cfg.clip_delta_norm > 0
    nus = [h.get("nu") for h in out["history"]] if clipped else []
    norms = [h["delta_norm"] for h in out["history"]] if clipped else []
    if clipped:
        print(f"  nu per step: {[round(v, 6) for v in nus]}")
        print(f"  applied |delta| per step: "
              f"{[float(f'{v:.4e}') for v in norms]}")
        if not all(v is not None and 0.0 < v <= 1.0 for v in nus):
            raise AssertionError(f"{label}: clip factor nu outside "
                                 f"(0, 1]: {nus}")
        if not all(math.isfinite(v) and v > 0.0 for v in norms):
            raise AssertionError(f"{label}: applied step norm not finite "
                                 f"and positive: {norms}")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, "
                             f"expected {want}")
    return {
        "steps": steps, "n_rows": N_ROWS, "step_ms": step_ms,
        "step_ms_median": srt[len(srt) // 2], "step_ms_min": srt[0],
        "step_ms_max": srt[-1],
        "plain_step_ms_median": plain[len(plain) // 2],
        "refresh_step_ms": {i: step_ms[i] for i in AE_REFRESH},
        "sweep_step_ms": step_ms[AE_SWEEP],
        "max_step_ms_after_warmup": after,
        "peak_mem_bytes": peak, "resident_bytes_before": resident,
        "losses": losses, "launches": launches,
        **({"nu": nus, "delta_norm": norms} if clipped else {})}


TAU1_ROWS = N_ROWS // 8      # the tau1 path's statistics rows


def modes_kernel_rows(dev, rows: dict, sides: list) -> None:
    """The kernels in the regimes the modes send them, each against its
    plain version as phase 3 holds it (the errors fold into the rows'
    ``max_abs_err``):

    - factor_update at τ1 = 1/8's 1024 rows of the 16 factor sides, beta 0
      and 0.95, and on strided views ``x[::8]`` of (8192, d) rows, as the
      sub-batch's records reach the wrapper; then timed there, row 2's
      ``cases["tau1"]``, beside ``addmm``;
    - ``core.inverse.ns_inverse`` hot-started from a stale inverse for 4
      iterations at each side's damped factor, against the same steps of
      ``ns_step_ref``: after a small drift (the safeguard holds: hot) and
      after a decayed update (where the safeguard fails: cold);
    - patch_factor on half of whisper-small's batch (τ1 = 0.5): conv1 on
      the strided view ``mels[::2]`` of (8, 3000, 80), conv2 on (4, 3000,
      768) s 2, N = 4 · 64 tokens."""
    from repro_torch.core import inverse as INV
    from repro_torch.kernels.factor_update import (factor_update,
                                                   factor_update_ref)
    from repro_torch.kernels.ns_step import cold_start, ns_step_ref
    from repro_torch.kernels.patch_factor import (patch_factor_update,
                                                  patch_factor_update_ref)
    g = torch.Generator(device=dev).manual_seed(28)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    eye = lambda d: torch.eye(d, device=dev)

    def gram(x):
        return x.T @ x / x.shape[0]

    print(f"[modes:kernels] factor_update at {TAU1_ROWS} rows, ns_step hot "
          f"from a stale inverse at 4 iterations, patch_factor on half of "
          f"whisper's batch")
    errs = {"factor_update": [], "ns_step": [], "patch_factor": []}
    eps = torch.tensor(0.95, device=dev)
    xs, cs = [], []
    for d in sides:
        full = torch.tanh(randn(N_ROWS, d))
        c = gram(torch.tanh(randn(512, d))) + 0.1 * eye(d)
        for label, x in (("", full[:TAU1_ROWS]),
                         (" strided view x[::8]", full[::8])):
            for e in (0.0, 0.95):
                b = torch.tensor(e, device=dev)
                a = (1 - b) / TAU1_ROWS
                prod = factor_update_ref(x, c, alpha=a, beta=0.0)
                compare(f"factor_update X({TAU1_ROWS},{d}){label} beta={e}",
                        factor_update(x, c, alpha=a, beta=b),
                        factor_update_ref(x, c, alpha=a, beta=b),
                        errs["factor_update"],
                        scale=prod.abs().max().item())
        if full[::8].is_contiguous():
            raise AssertionError("the strided view is contiguous")
        xs.append(full[::8].contiguous())
        cs.append(c)
        # the inverse held from before an update: a small drift (the
        # safeguard ‖I − M X0‖∞ < 1 holds, so NS starts hot; it must) and
        # one decayed update with a new sub-batch (it may not hold: then
        # that matrix starts cold, as in the reference)
        m_old = gram(full) + 0.1 * eye(d)
        new = gram(torch.tanh(randn(TAU1_ROWS, d))) + 0.1 * eye(d)
        x0 = torch.linalg.inv(m_old)
        for drift, m in (("drift 1e-4", m_old + 1e-4 * new),
                         ("decayed update", 0.95 * m_old + 0.05 * new)):
            bad = bool(torch.amax(torch.sum(torch.abs(eye(d) - m @ x0),
                                            dim=-1)) >= 1)
            if bad and drift == "drift 1e-4":
                raise AssertionError(f"d={d}: the hot start's safeguard "
                                     f"fails at a drift of 1e-4")
            x = cold_start(m) if bad else x0
            for _ in range(4):
                x = ns_step_ref(m, x)
            compare(f"ns_inverse d={d} {drift}, 4 iterations "
                    f"{'cold: the safeguard failed' if bad else 'hot'}",
                    INV.ns_inverse(m, 4, x0), 0.5 * (x + x.T),
                    errs["ns_step"])
        del full
    fu = lambda f: [f(x, c, alpha=(1 - eps) / TAU1_ROWS, beta=eps)
                    for x, c in zip(xs, cs)]
    case = dict(
        unit=f"all 16 factor sides of one tau1 = 1/8 stats step, X "
             f"({TAU1_ROWS}, d)",
        **timings(lambda: fu(factor_update), lambda: fu(factor_update_ref),
                  lambda: [torch.addmm(c, x.T, x, beta=0.95,
                                       alpha=0.05 / TAU1_ROWS)
                           for x, c in zip(xs, cs)]),
        bound=bound_ms(float(TAU1_ROWS) * sum(d * (d + 1) for d in sides),
                       4.0 * sum(TAU1_ROWS * d + 2 * d * d for d in sides)))
    rows["factor_update"]["cases"]["tau1"] = case
    print(f"  factor_update tau1 unit: {fmt_ms(case['ms'])} ms, plain "
          f"{fmt_ms(case['plain_ms'])}, addmm {fmt_ms(case['library_ms'])}, "
          f"bound {case['bound'][0]:.4f} ({case['bound'][1]}; "
          f"{case['bound'][0] / case['ms']:.1%} of it)")
    del xs, cs

    n_tok = 4 * 64
    mels = randn(8, 3000, 80)
    for x, c_in, stride in ((mels[::2], 80, 1),
                            (randn(4, 3000, 768), 768, 2)):
        d = 3 * c_in + 1
        kw = dict(taps=3, stride=stride, padding="SAME", has_bias=True)
        old = gram(torch.tanh(randn(512, d)))
        prod = patch_factor_update_ref(x, old, alpha=(1 - eps) / n_tok,
                                       beta=0.0, **kw)
        compare(f"patch_factor x{tuple(x.shape)} s={stride} contiguous "
                f"{x.is_contiguous()} beta=0.95",
                patch_factor_update(x, old, alpha=(1 - eps) / n_tok,
                                    beta=eps, **kw),
                patch_factor_update_ref(x, old, alpha=(1 - eps) / n_tok,
                                        beta=eps, **kw),
                errs["patch_factor"], scale=prod.abs().max().item())
    del mels
    for name, e in errs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], *e)
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recording(module, name: str, shapes: list):
    """``module.<name>`` wrapped inside: each call appends its first
    argument's shape to ``shapes``, then calls the function."""
    keep = getattr(module, name)

    def wrapped(x, *args, **kw):
        shapes.append(tuple(x.shape))
        return keep(x, *args, **kw)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, keep)


def modes_summary(main_out: dict) -> dict:
    """What the modes change (printed and recorded, not held): the
    plain-step medians beside the modes phase's own blkdiag run, the
    staggered paths' largest step after the warmup (the sweep aside)
    beside phase 5's T3 refresh steps of their base path, and
    stats_period=2's step medians with and without a statistics pass."""
    m = main_out
    sp = m["modes_stats_period2"]["step_ms"]
    plain = [i for i in range(AE_STEPS)
             if i not in (0, AE_SWEEP, *AE_REFRESH)]
    med = lambda xs: sorted(xs)[len(xs) // 2]
    out = {
        "plain_step_ms_median": {
            label: m[key]["plain_step_ms_median"]
            for label, key in (("blkdiag", "modes_blkdiag"),
                               ("tau1", "modes_tau1"),
                               ("gaussian", "modes_gaussian"))},
        "staggered_max_after_warmup_vs_base_refresh": {
            label: {"max_step_ms_after_warmup":
                    m[f"modes_{label}"]["max_step_ms_after_warmup"],
                    "base_t3_refresh_ms": [m[base]["refresh_step_ms"][i]
                                           for i in (5, 10, 15)]}
            for label, base in (("staggered", "blkdiag"),
                                ("staggered_eigen", "eigen"),
                                ("staggered_tridiag", "tridiag"))},
        "stats_period2_step_ms_median": {
            "with_stats": med([sp[i] for i in plain if i % 2 == 0]),
            "without_stats": med([sp[i] for i in plain if i % 2 == 1])},
    }
    print(f"[modes] {json.dumps(out)}")
    return out


WM_STEPS = 6


def whisper_modes(steps: int = WM_STEPS) -> dict:
    """Full-width whisper-small through ``launch/train.py --tau1 0.5
    --refresh_mode staggered``: the statistics pass on every other
    sequence (4 of 8), the warmup's full refreshes at steps 0-2, then one
    group of ``stagger_groups()`` a step at ``ns_hot_iters``.  patch_factor
    runs exactly twice a step, each time on the 4-sequence sub-batch (its
    inputs' shapes are recorded); every launch count exact; per-step host
    ms and peak memory."""
    from repro_torch import kernels as K
    from repro_torch.core.blocks import conv as conv_block
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    K.reset_launches()
    ms, shapes, held = [], [], {}

    def wrap(opt):
        held["engine"] = opt.engine
        return timed(opt, ms)

    t0 = time.perf_counter()
    with recording(conv_block, "patch_factor_update", shapes):
        res = train.main(["--arch", "whisper-small", "--steps", str(steps),
                          "--tau1", "0.5", "--refresh_mode", "staggered"],
                         log=lambda msg: print(f"  {msg}"), wrap_opt=wrap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches()
    peak = torch.cuda.max_memory_allocated()
    eng = held["engine"]
    cfg, groups = eng.cfg, eng.stagger_groups()
    full = {n: (m.a_kind == "full") + (m.g_kind == "full")
            for n, m in eng.metas.items()}
    n_full, n_blocks, n_factor_sides = sum(full.values()), 20, 38
    ns_by_step = [n_full * cfg.ns_iters if i < 3 else
                  sum(full[n] for n in groups[i % cfg.t3]) * cfg.ns_hot_iters
                  for i in range(steps)]
    ns = sum(ns_by_step)
    want = {name: 0 for name in K.WRAPPERS}
    want.update(patch_factor=2 * steps, factor_update=n_factor_sides * steps,
                precondition=n_blocks * steps, ns_step=ns,
                matmul=2 * (n_blocks * steps + ns))
    losses = [h["loss"] for h in res["history"]]
    after = ms[3:]
    print(f"[modes:whisper] full-width whisper-small, --tau1 0.5 "
          f"--refresh_mode staggered, batch 8, seq 64, {steps} steps in "
          f"{wall:.1f} s")
    print(f"  groups (T3 = {cfg.t3}): {groups}; ns_step launches a step "
          f"{ns_by_step}")
    print(f"  per-step ms: {[round(t, 1) for t in ms]}; largest step after "
          f"the warmup {max(after):.1f} ms; peak memory "
          f"{peak / 2 ** 20:.1f} MiB, of which {resident / 2 ** 20:.1f} MiB "
          f"was allocated before")
    print(f"  patch_factor inputs: {sorted(set(shapes))}")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    print(f"  launches: {launches}")
    if (not all(math.isfinite(v) for v in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"whisper modes: loss not finite and falling: "
                             f"{losses}")
    if len(shapes) != 2 * steps or any(s[0] != 4 for s in shapes):
        raise AssertionError(f"whisper modes: patch_factor not twice a step "
                             f"on the 4-sequence sub-batch: {shapes}")
    if launches != want:
        raise AssertionError(f"whisper modes: launch counts {launches}, "
                             f"expected {want}")
    out = {"steps": steps, "tau1": cfg.tau1, "groups": groups,
           "ns_step_by_step": ns_by_step, "step_ms": ms,
           "max_step_ms_after_warmup": max(after),
           "peak_mem_bytes": peak, "resident_bytes_before": resident,
           "patch_factor_inputs": sorted(set(shapes)), "losses": losses,
           "launches": launches, "wall_s": wall}
    del res
    torch.cuda.empty_cache()
    return out


# the race's first-order rows: (row, optimizer, its arguments), momentum 0.9
RACE_BASELINES = [(f"sgd_momentum_lr{lr}", "sgd_momentum",
                   {"lr": lr, "momentum": 0.9}) for lr in (0.03, 0.1, 0.3)]
RACE_BASELINES.append(("adam_lr0.01", "adam", {"lr": 1e-2}))


def race_main(mlp, params, data, kfac_rows: dict,
              steps: int = AE_STEPS) -> dict:
    """The optimizer race at full width (phase "race"): phase 5's model,
    weights and data, ``steps`` steps of each first-order row and of
    blkdiag K-FAC without momentum through ``Trainer.fit`` under ``timed``;
    ``kfac_rows`` maps the rows ``kfac_blkdiag`` and ``kfac_tridiag`` to
    phase 5's runs of those paths (``autoencoder_main``'s dicts).
    The time to a target sums the host ms of the steps through the first
    one whose loss (computed in that step's gradient pass, before its
    update) is at or below it.  The race's target is the best SGD row's
    final loss; the best first-order row's final loss is a second one."""
    from repro_torch import kernels as K
    from repro_torch import optimizers
    zero = {name: 0 for name in K.WRAPPERS}
    specs = [(row, optimizers.get(kind, mlp, **kw), zero, (0,))
             for row, kind, kw in RACE_BASELINES]
    nomom = dataclasses.replace(ae_paths()["blkdiag"], use_momentum=False)
    kfac_skip = (0, AE_SWEEP, *AE_REFRESH)
    specs.append(("kfac_blkdiag_no_momentum",
                  optimizers.kfac(mlp, nomom, family="bernoulli",
                                  device="cuda"),
                  ae_launches("blkdiag_no_momentum", steps), kfac_skip))
    rows = {}
    for row, opt, want, skip in specs:
        print(f"[race:{row}] full width {mlp.dims}, N={N_ROWS}, {steps} "
              f"steps")
        out, step_ms, launches, peak, _ = fit_timed(opt, mlp, params, data,
                                                    steps)
        losses = [h["loss"] for h in out["history"]]
        plain = sorted(t for i, t in enumerate(step_ms) if i not in skip)
        rows[row] = {"step_ms": step_ms,
                     "plain_step_ms_median": plain[len(plain) // 2],
                     "total_ms": sum(step_ms), "losses": losses,
                     "final_loss": losses[-1], "peak_mem_bytes": peak,
                     "launches": launches}
        if launches != want:
            raise AssertionError(f"race {row}: launch counts {launches}, "
                                 f"expected {want}")
    for row, run in kfac_rows.items():
        rows[row] = {
            "step_ms": run["step_ms"],
            "plain_step_ms_median": run["plain_step_ms_median"],
            "total_ms": sum(run["step_ms"]), "losses": run["losses"],
            "final_loss": run["losses"][-1],
            "peak_mem_bytes": run["peak_mem_bytes"],
            "launches": run["launches"]}
    for row, r in rows.items():
        print(f"  {row}: per-step ms {[round(t, 3) for t in r['step_ms']]}")
        print(f"    plain-step median {r['plain_step_ms_median']:.3f} ms, "
              f"total {r['total_ms']:.1f} ms; loss {r['losses'][0]:.4f} -> "
              f"{r['final_loss']:.4f}; peak memory "
              f"{r['peak_mem_bytes'] / 2 ** 20:.1f} MiB")
        print(f"    launches: {r['launches']}")
    final = {row: r["final_loss"] for row, r in rows.items()}
    first_order = {row: final[row] for row, _, _ in RACE_BASELINES}
    sgd = {row: v for row, v in first_order.items() if row.startswith("sgd")}
    # the race's target, and beside it the best first-order row's final
    # loss, which stays informative where every SGD rate climbs
    targets = {"best_sgd": min(sgd, key=sgd.get),
               "best_first_order": min(first_order, key=first_order.get)}
    for tname, trow in targets.items():
        target = final[trow]
        print(f"[race] time to {tname}: {trow}'s final loss {target:.4f}")
        for row, r in rows.items():
            hit = next((i for i, v in enumerate(r["losses"])
                        if v <= target), None)
            r.setdefault("to_target", {})[tname] = {
                "step": hit,
                "ms": None if hit is None else sum(r["step_ms"][:hit + 1])}
            print(f"  {row}: " + ("not reached" if hit is None else
                                  f"step {hit}, "
                                  f"{r['to_target'][tname]['ms']:.1f} ms"))
    best_sgd = targets["best_sgd"]
    claims = {
        "kfac_below_best_sgd": final["kfac_blkdiag"] < final[best_sgd],
        "kfac_below_no_momentum": (final["kfac_blkdiag"]
                                   < final["kfac_blkdiag_no_momentum"]),
        "no_momentum_below_adam": (final["kfac_blkdiag_no_momentum"]
                                   < final["adam_lr0.01"]),
        "adam_below_best_sgd": final["adam_lr0.01"] < final[best_sgd],
        # examples/autoencoder_kfac.py: tridiag beats blkdiag per iteration
        "tridiag_at_or_below_blkdiag": (final["kfac_tridiag"]
                                        <= final["kfac_blkdiag"])}
    print(f"[race] claims (only the first is held): {claims}")
    bad = {row: r["losses"] for row, r in rows.items()
           if not all(math.isfinite(v) for v in r["losses"])}
    if bad:
        raise AssertionError(f"race: loss not finite: {bad}")
    if not claims["kfac_below_best_sgd"]:
        raise AssertionError(f"race: K-FAC's final loss "
                             f"{final['kfac_blkdiag']} is not below the best "
                             f"SGD row's ({best_sgd}, {final[best_sgd]})")
    return {"steps": steps, "n_rows": N_ROWS,
            "targets": {t: {"row": r, "loss": final[r]}
                        for t, r in targets.items()},
            "claims": claims, "rows": rows}


def lm_adam(arch: str, steps: int = 3, cfg=None) -> dict:
    """Full-width ``arch`` (``cfg``: cut in depth) through
    ``launch/train.py --optimizer adam --lr 1e-3``: the loss finite and no
    kernel of ``repro_torch.kernels`` launched; per-step host ms and peak
    memory."""
    from repro_torch import kernels as K
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    K.reset_launches()
    ms = []
    res = train.main(["--arch", arch, "--optimizer", "adam", "--lr", "1e-3",
                      "--steps", str(steps)],
                     log=lambda msg: print(f"  {msg}"),
                     wrap_opt=lambda opt: timed(opt, ms), cfg=cfg)
    torch.cuda.synchronize()
    launches = K.launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in res["history"]]
    plain = sorted(ms[1:])
    depth = "" if cfg is None else f" at {cfg.n_layers} layers"
    print(f"[main:{arch}-adam] full-width {arch}{depth}, Adam lr 1e-3, "
          f"batch 8, seq 64, {steps} steps")
    print(f"  per-step ms: {[round(t, 1) for t in ms]}; plain-step median "
          f"{plain[len(plain) // 2]:.1f} ms (step 0 includes the first "
          f"calls' set-up); peak memory {peak / 2 ** 20:.1f} MiB, of which "
          f"{resident / 2 ** 20:.1f} MiB was allocated before")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    print(f"  launches: {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{arch} adam: loss not finite: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{arch} adam: kernels launched: {launches}")
    del res
    torch.cuda.empty_cache()
    return {"steps": steps, "step_ms": ms,
            "plain_step_ms_median": plain[len(plain) // 2],
            "peak_mem_bytes": peak, "resident_bytes_before": resident,
            "losses": losses, "launches": launches}


# ---- the "ckpt" phase: checkpoints, resume, preemption, bundles ------------

CKPT_AT, CKPT_TO = 7, 12      # the autoencoder's checkpoint and resume end
W_CKPT_TO = W_STEPS + 2       # whisper's relaunch: two steps after step 10


def ckpt_dir(label: str) -> str:
    """A fresh ``tempfile.mkdtemp()`` directory, its disk usage printed."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix=f"ckpt_{label}_")
    du = shutil.disk_usage(d)
    print(f"[ckpt:{label}] {d}: disk total {du.total / 2 ** 30:.1f} GiB, "
          f"used {du.used / 2 ** 30:.1f} GiB, free {du.free / 2 ** 30:.1f} "
          f"GiB")
    return d


def recording_checkpointer(directory: str):
    """A ``Checkpointer`` on ``directory`` that also keeps its own host
    copy of every tree it saves, taken at the save (``copies[step]``)."""
    from repro_torch.training.checkpoint import Checkpointer, host_copy

    class Recording(Checkpointer):
        def save(self, step, tree, **kw):
            self.copies[step] = host_copy(tree)
            return super().save(step, tree, **kw)

    ck = Recording(directory)
    ck.copies = {}
    return ck


def _bitwise(label: str, got: dict, want: dict, what: str) -> None:
    """``got`` holds ``want``'s keys, each array with its dtype and bits."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: {what}: keys differ: "
                             f"{sorted(set(got) ^ set(want))[:8]}")
    for k, v in want.items():
        a = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) \
            else got[k]
        if a.dtype != v.dtype or a.shape != v.shape or not np.array_equal(
                a, v):
            raise AssertionError(f"{label}: {what}: {k} differs")


def _sigterm_at(data, at: int):
    """``data`` that sends this process SIGTERM while step ``at``'s batch
    is built."""
    import os
    import signal

    class Data:
        def batch(self, step):
            if step == at:
                os.kill(os.getpid(), signal.SIGTERM)
            return data.batch(step)

    return Data()


def ckpt_preempt(mlp, params, data) -> dict:
    """SIGTERM while step 3's batch is built, on blkdiag: ``fit`` finishes
    step 3, commits ``step_00000004`` by a blocking save and stops; the
    SIGTERM handler is afterwards what it was before."""
    import os
    import shutil
    import signal
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optimizers.kfac import kfac
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.trainer import Trainer
    d = ckpt_dir("preempt")
    ck = Checkpointer(d)
    before = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    out = Trainer(mlp, kfac(mlp, ae_paths()["blkdiag"], family="bernoulli",
                            device="cuda"),
                  TrainConfig(steps=AE_STEPS, seed=0, log_every=10 ** 9),
                  device="cuda", checkpointer=ck).fit(
        params, _sigterm_at(data, 3), steps=AE_STEPS,
        log=lambda msg: print(f"  {msg}"))
    wall = time.perf_counter() - t0
    after = signal.getsignal(signal.SIGTERM)
    steps = ck.all_steps()
    print(f"[ckpt:preempt] SIGTERM at step 3's batch: {len(out['history'])} "
          f"steps run, committed checkpoints {steps}, handler before "
          f"{before!r}, after {after!r}; blocking save "
          f"{ck.stats['save_host_ms']:.1f} ms host copy + "
          f"{ck.stats['write_s']:.3f} s write; {wall:.1f} s")
    if len(out["history"]) != 4 or steps != [4] or not os.path.exists(
            os.path.join(d, "step_00000004", "COMMIT")):
        raise AssertionError(f"preempt: {len(out['history'])} steps, "
                             f"checkpoints {steps}")
    if after != before:
        raise AssertionError(f"preempt: SIGTERM handler {after!r} after fit, "
                             f"{before!r} before")
    shutil.rmtree(d)
    return {"steps_run": len(out["history"]), "checkpoints": steps,
            **ck.stats}


def ckpt_bundle_checks(label, mlp, ck, copy, state) -> dict:
    """The bundle written at step 7 (eigen: bitwise the state's ``inv``;
    blkdiag: the ``rotate_rescale`` apply of the loaded bundle against the
    ``precondition`` kernel on the eigh-damped inverses of the same factors
    and γ, within min(5e-6·κ, 2e-3); eigen also a bfloat16 bundle)."""
    from repro_torch.curvature import load_bundle, save_bundle
    from repro_torch.curvature import snapshot_bundle
    from repro_torch.optimizers.kfac import kfac
    path = ck.bundle_path(CKPT_AT)
    if path is None:
        raise AssertionError(f"{label}: no curvature bundle at step "
                             f"{CKPT_AT}")
    engine = kfac(mlp, ae_paths()[label], family="bernoulli",
                  device="cuda").engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snapshot_bundle(engine, state)
    torch.cuda.synchronize()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    bundle = load_bundle(path, device="cuda")
    out = {"snapshot_ms": snapshot_ms, "bundle_step": bundle.step}
    if label == "eigen":
        got = {f"state::inv::{n}::{k}": v for n, e in bundle.eigen.items()
               for k, v in e.items()}
        _bitwise(label, got, {k: copy[k] for k in got}, "bundle vs inv")
        half_dir = path + "_bf16"
        save_bundle(bundle, half_dir, dtype="bfloat16")
        half = load_bundle(half_dir, device="cuda")
        for n, e in bundle.eigen.items():
            for k in ("qa", "qg"):
                if not torch.equal(half.eigen[n][k],
                                   e[k].to(torch.bfloat16).float()):
                    raise AssertionError(f"{label}: bf16 bundle {n} {k}")
        print(f"[ckpt:{label}] bundle at step {bundle.step}: qa/qg/s/damp "
              f"bitwise the state's inv; bf16 bases bitwise "
              f"q.to(torch.bfloat16).float()")
        out["bf16_bitwise"] = True
    if label == "blkdiag":
        errs = {}
        g = torch.Generator(device="cuda").manual_seed(11)
        gamma = torch.from_numpy(copy["state::gamma"]).cuda()
        for n, blk in engine.blocks.items():
            fac = {s: torch.from_numpy(copy[f"state::factors::{n}::{s}"])
                   .cuda() for s in ("a", "g")}
            m = blk.meta
            v = torch.randn(m.a_dim, m.g_dim, generator=g, device="cuda")
            eig = bundle.eigen[n]
            got = blk.precondition_eigen(eig, v)
            want = blk.precondition(blk.damped_inverse(
                fac, gamma, method="eigh"), v)
            sd = eig["s"] + eig["damp"]
            kappa = (sd.max() / sd.min()).item()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            errs[n] = {"max_abs_err": err, "scale": scale, "kappa": kappa}
            # queue C's eigen-vs-eigh 5e-6·κ, capped at 2e-3: 4x the
            # largest relative error the card has shown (5.0e-4 at κ 4.6e4)
            ok = (math.isfinite(err)
                  and err <= min(5e-6 * kappa, 2e-3) * scale)
            print(f"  {label} bundle apply {n}: rotate_rescale vs eigh "
                  f"precondition max|err| {err:.3e}, scale {scale:.3e}, "
                  f"kappa {kappa:.3e}, tol min(5e-6*kappa, 2e-3)*scale "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: bundle apply {n} "
                                     f"disagrees: {err:.3e}")
        out["apply"] = errs
    return out


def ckpt_ae(label: str, mlp, params, data, main_losses: list) -> dict:
    """One phase-5 path: ``Trainer.fit`` to step 7 with an asynchronous
    ``Checkpointer`` (and, on blkdiag and eigen, a curvature bundle), then
    a new optimizer and trainer resume from step 7 to 12.  Held: the arrays
    read back bitwise a host copy taken at the save; the first run's losses
    and the resumed run's first loss bitwise phase 5's; exact launch counts
    of both runs, the resumed one's with its warmup re-armed at step 7;
    the checkpoint restored into a CPU template bitwise; on blkdiag a
    second resume bitwise the first."""
    import os
    import shutil
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optimizers.kfac import kfac
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.trainer import Trainer
    from repro_torch.utils.tree import flatten_with_keys, unflatten_with_keys

    cfg = ae_paths()[label]
    bundles = label in ("blkdiag", "eigen")
    d = ckpt_dir(label)
    tcfg = TrainConfig(steps=CKPT_TO, seed=0, log_every=10 ** 9,
                       checkpoint_every=CKPT_AT,
                       curvature_every=CKPT_AT if bundles else 0)
    opt = lambda: kfac(mlp, cfg, family="bernoulli", device="cuda")
    ck = recording_checkpointer(d)
    trainer = Trainer(mlp, opt(), tcfg, device="cuda", checkpointer=ck)
    torch.cuda.synchronize()
    K.reset_launches()
    first = trainer.fit(params, data, steps=CKPT_AT, log=lambda *_: None)
    torch.cuda.synchronize()
    launches_first = K.launches()
    saved = dict(ck.stats)
    if bundles:
        saved["bundle_write_s"] = trainer._bundle_writer.write_s
    copy = ck.copies[CKPT_AT]
    step_dir = os.path.join(d, f"step_{CKPT_AT:08d}")
    with np.load(os.path.join(step_dir, "arrays.npz")) as z:
        read = {k: z[k] for k in z.files}
    _bitwise(label, read, copy, "arrays.npz vs the host copy at the save")
    npz_bytes = os.path.getsize(os.path.join(step_dir, "arrays.npz"))
    losses_first = [h["loss"] for h in first["history"]]
    if losses_first != main_losses[:CKPT_AT]:
        raise AssertionError(f"{label}: steps 0-6 {losses_first} differ "
                             f"from phase 5's {main_losses[:CKPT_AT]}")

    def resume():
        checkpointer = Checkpointer(d)
        tr = Trainer(mlp, opt(), tcfg, device="cuda",
                     checkpointer=checkpointer)
        torch.cuda.synchronize()
        K.reset_launches()
        out = tr.fit(params, data, steps=CKPT_TO, log=lambda *_: None)
        torch.cuda.synchronize()
        return out, K.launches(), dict(checkpointer.stats)

    second, launches, restored = resume()
    losses = [h["loss"] for h in second["history"]]
    want_first = ae_launches(label, CKPT_AT)
    want = ae_launches(label, CKPT_TO, start=CKPT_AT)
    by_size = {}
    for k, v in copy.items():
        part = k.split("::")[1] if k.startswith("state::") else "params"
        by_size[part] = by_size.get(part, 0) + v.nbytes
    print(f"[ckpt:{label}] checkpoint at step {CKPT_AT}: "
          f"{saved['bytes']:,} bytes ({npz_bytes:,} in arrays.npz; "
          f"{dict(sorted(by_size.items()))}); save host copy "
          f"{saved['save_host_ms']:.2f} ms, write {saved['write_s']:.3f} s "
          f"on the thread; restore read {restored['restore_read_s']:.3f} s, "
          f"to device {restored['restore_device_s']:.3f} s")
    print(f"  arrays.npz read back bitwise the host copy at the save "
          f"({len(copy)} arrays); steps 0-{CKPT_AT - 1} bitwise phase 5's")
    print(f"  resumed losses {losses} (phase 5's step {CKPT_AT}: "
          f"{main_losses[CKPT_AT]})")
    print(f"  launches to step {CKPT_AT}: {launches_first}")
    print(f"  launches resumed {CKPT_AT}-{CKPT_TO - 1} (warmup re-armed): "
          f"{launches}")
    if losses[0] != main_losses[CKPT_AT]:
        raise AssertionError(f"{label}: resumed first loss {losses[0]} is "
                             f"not phase 5's {main_losses[CKPT_AT]}")
    if len(losses) != CKPT_TO - CKPT_AT or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: resumed losses {losses}")
    if launches_first != want_first or launches != want:
        raise AssertionError(f"{label}: launches {launches_first} / "
                             f"{launches}, expected {want_first} / {want}")
    # the card-written checkpoint restored into a CPU template
    template = {"params": params,
                "state": opt().init(params, data.batch(0))}
    cpu_template = unflatten_with_keys(template, flatten_with_keys(template),
                                       lambda _, t: t.cpu())
    _, on_cpu = Checkpointer(d).restore(cpu_template)
    flat = flatten_with_keys(on_cpu)
    if any(t.device.type != "cpu" for t in flat.values()):
        raise AssertionError(f"{label}: CPU restore left a leaf on the card")
    _bitwise(label, flat, {k: copy[k] for k in flat}, "restore on the CPU")
    tri = on_cpu["state"].inv.get("__tri__", "absent")
    print(f"  restored into a CPU template bitwise ({len(flat)} arrays; "
          f"the tridiag cache: {'None' if tri is None else tri})")
    if label == "tridiag" and tri is not None:
        raise AssertionError("tridiag: the Ψ/Σ cache was restored")
    out = {"bytes": saved["bytes"], "npz_bytes": npz_bytes,
           "bytes_by_part": by_size, **saved,
           "restore_read_s": restored["restore_read_s"],
           "restore_device_s": restored["restore_device_s"],
           "resumed_losses": losses, "launches_first": launches_first,
           "launches": launches}
    if label == "blkdiag":
        again, launches2, _ = resume()
        if ([h["loss"] for h in again["history"]] != losses
                or launches2 != launches):
            raise AssertionError(f"{label}: a second resume differs")
        _bitwise(label, {k: v.cpu().numpy() for k, v in flatten_with_keys(
            again["params"]).items()}, {k: v.cpu().numpy() for k, v in
                                        flatten_with_keys(
                                            second["params"]).items()},
                 "second resume's parameters")
        print("  a second resume from the same checkpoint: history and "
              "parameters bitwise the first's")
    if bundles:
        out["bundle"] = ckpt_bundle_checks(label, mlp, ck, copy,
                                           first["state"])
        print(f"  bundle snapshot {out['bundle']['snapshot_ms']:.2f} ms, "
              f"write {saved['bundle_write_s']:.3f} s on the thread")
    shutil.rmtree(d)
    return out


def whisper_ckpt_bytes() -> int:
    """The bytes a full-width whisper-small blkdiag checkpoint holds, from
    its metas: parameters and ``delta0``, each block's two factors and two
    inverses (a full side d², a diagonal one d; stacked layers times their
    stack), the untagged parameters' diagonals."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    lm = LM(get_config("whisper-small"), device="cuda")
    tagged = 0
    factors = 0
    for m in lm.metas.values():
        side = lambda dim, kind: dim if kind == "diag" else dim * dim
        factors += max(1, m.n_stack) * (side(m.a_dim, m.a_kind)
                                        + side(m.g_dim, m.g_kind))
        tagged += max(1, m.n_stack) * m.d_out * m.a_dim
    n = lm.n_params()
    return 4 * (2 * n + 2 * factors + (n - tagged))


@contextlib.contextmanager
def launcher_checkpointer(seen: dict):
    """``launch/train.py``'s ``Checkpointer`` swapped, inside, for one that
    records itself in ``seen["ckpt"]`` and, around each restore, the
    device memory before, at its peak and after."""
    from repro_torch.launch import train

    class Measured(train.Checkpointer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen["ckpt"] = self

        def restore(self, template, **kw):
            torch.cuda.synchronize()
            seen["before"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = super().restore(template, **kw)
            seen["peak"] = torch.cuda.max_memory_allocated()
            seen["after"] = torch.cuda.memory_allocated()
            return got

    keep, train.Checkpointer = train.Checkpointer, Measured
    try:
        yield seen
    finally:
        train.Checkpointer = keep


def whisper_resume(d: str) -> dict:
    """A relaunch of ``launch/train.py --steps 12 --ckpt_dir`` on the
    directory of the whisper phase's 10-step run: it resumes at step 10
    and runs steps 10 and 11, both warmup refreshes (re-armed at the
    restore), with exact launch counts and a finite loss; the restore's
    read and to-device seconds and the device's peak during it."""
    from repro_torch import kernels as K
    from repro_torch.launch import train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    K.reset_launches()
    ms, logs, seen = [], [], {}
    with launcher_checkpointer(seen):
        res = train.main(["--arch", "whisper-small", "--steps",
                          str(W_CKPT_TO), "--ckpt_dir", d],
                         log=lambda msg: (logs.append(msg),
                                          print(f"  {msg}")),
                         wrap_opt=lambda opt: timed(opt, ms))
    torch.cuda.synchronize()
    launches = K.launches()
    losses = [h["loss"] for h in res["history"]]
    refresh = [s for s in range(W_STEPS, W_CKPT_TO)
               if s - W_STEPS < 3 or s % 5 == 0]
    want = whisper_launches(W_CKPT_TO, W_STEPS)
    st = seen["ckpt"].stats
    print(f"[ckpt:whisper] relaunch --steps {W_CKPT_TO}: restore read "
          f"{st['restore_read_s']:.2f} s, to device "
          f"{st['restore_device_s']:.2f} s; device "
          f"{seen['before'] / 2 ** 20:.1f} MiB before the restore, peak "
          f"{seen['peak'] / 2 ** 20:.1f} MiB during it, "
          f"{seen['after'] / 2 ** 20:.1f} MiB after")
    print(f"  per-step ms {[round(t, 1) for t in ms]} (refresh steps "
          f"{refresh}); losses {losses}")
    print(f"  launches: {launches}")
    if f"[trainer] restored checkpoint at step {W_STEPS}" not in logs:
        raise AssertionError("whisper relaunch: no restore at step "
                             f"{W_STEPS}")
    if len(losses) != W_CKPT_TO - W_STEPS or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"whisper relaunch: losses {losses}")
    if launches != want:
        raise AssertionError(f"whisper relaunch: launch counts {launches}, "
                             f"expected {want}")
    del res
    torch.cuda.empty_cache()
    return {"restore_read_s": st["restore_read_s"],
            "restore_device_s": st["restore_device_s"],
            "restore_peak_bytes": seen["peak"],
            "restore_before_bytes": seen["before"],
            "restore_after_bytes": seen["after"], "step_ms": ms,
            "losses": losses, "launches": launches,
            "refresh_steps": refresh}


# ---- the "conv" phase: KFC convolutions and fused statistics --------------

CONV_N = 512                  # images a step (bench_optimizer_race.py:63)
CONV_SEED = 7                 # the data's seed; weights from seed 0
# one conv classifier step's factor sides at full width and N = 512:
# (label, rows, d), the im2col rows of each conv's A side and the outputs
# of each layer's G side
CONV_SIDES = [("conv0 A", 512 * 1024, 28), ("conv0 G", 512 * 1024, 32),
              ("conv1 A", 512 * 256, 289), ("conv1 G", 512 * 256, 32),
              ("conv2 A", 512 * 64, 289), ("conv2 G", 512 * 64, 64),
              ("head A", 512, 65), ("head G", 512, 10)]
CONV_TIMED = ("conv0 A", "conv1 A")


# the conv classifier's fused chain: phase 5's chain at fixed_lr 0.5 and
# kl_clip 0.1 (the autoencoder's 0.02 and 1e-3 leave it at chance); chosen
# by tools/conv_lr_sweep.py on the CPU at N = 64 and 256
CONV_CHAIN = dict(fixed_lr=0.5, kl_clip=0.1)
# every path's last loss must sit this far under the classes' ln 10
CONV_LOSS_MARGIN = 0.5


def conv_paths() -> dict:
    """The conv classifier's paths: phase 5's blkdiag (ns) and eigen
    configurations and its fused chain at ``CONV_CHAIN``, each two-pass and
    with ``fused_stats`` (label suffix ``_fs``)."""
    base = ae_paths()
    base["fused"] = dataclasses.replace(base["fused"], **CONV_CHAIN)
    out = {}
    for label in ("blkdiag", "eigen", "fused"):
        out[label] = base[label]
        out[f"{label}_fs"] = dataclasses.replace(base[label],
                                                 fused_stats=True)
    return out


def conv_model(cfg, device: str, n: int = CONV_N):
    """The conv classifier, its weights from seed 0 and its synthetic
    images (``SyntheticImageData``, seed 7), on ``device``."""
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models.convnet import ConvNet
    net = ConvNet(cfg, device=device)
    params = net.init_params(torch.Generator().manual_seed(0))
    data = SyntheticImageData(cfg.image_size, cfg.channels, cfg.n_classes,
                              n, seed=CONV_SEED, device=device)
    return net, params, data


def agree_conv(label: str, cfg) -> list:
    """The reduced conv classifier (8×8×2 images, convs (8, 3, 1) and (8,
    3, 2), 4 classes, N = 128) for 6 K-FAC steps of one path on the card
    and on the CPU (``agree_run``, phase 4's tolerance)."""
    from repro_torch.configs.conv_classifier import reduced
    return agree_run(f"conv:agree:{label}", "reduced conv classifier",
                     lambda where: conv_model(reduced(), where, n=128), cfg,
                     "categorical")


def conv_kernel_rows(dev, rows: dict) -> None:
    """factor_update at every factor side of one conv classifier step
    (``CONV_SIDES``: im2col rows of 28 and 289 features, deep K over an
    output of one or a few tiles) against its plain version at beta = 0
    and 0.95, held as phase 3 holds it (the errors fold into the row's
    ``max_abs_err``); then conv0's and conv1's A sides timed beside addmm,
    with their launch plans (``gemm_plan.triangle_plan``) and bounds, as
    the row's cases ``conv0`` and ``conv1``."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.factor_update import (factor_update,
                                                   factor_update_ref)
    row = rows["factor_update"]
    g = torch.Generator(device=dev).manual_seed(3)
    errs = []
    for label, n, d in CONV_SIDES:
        x = torch.tanh(torch.randn(n, d, generator=g, device=dev))
        y = torch.tanh(torch.randn(512, d, generator=g, device=dev))
        c = y.T @ y / 512 + 0.1 * torch.eye(d, device=dev)
        for e in (0.0, 0.95):
            eps = torch.tensor(e, device=dev)
            a = (1 - eps) / n
            prod = factor_update_ref(x, c, alpha=a, beta=0.0)
            compare(f"factor_update {label} X({n},{d}) beta={e}",
                    factor_update(x, c, alpha=a, beta=eps),
                    factor_update_ref(x, c, alpha=a, beta=eps), errs,
                    scale=prod.abs().max().item())
        if label not in CONV_TIMED:
            continue
        p = gemm_plan.triangle_plan(d, d, False, n,
                                    gemm_plan.sm_count(dev.index or 0))
        eps = torch.tensor(0.95, device=dev)
        case = dict(
            unit=f"{label} of the conv classifier, X ({n}, {d})",
            plan=(f"tile {p.tile}, {p.tiles} tiles a side, {p.blocks} "
                  f"blocks, chunk {p.chunk}, splits {p.splits}"),
            **timings(lambda: factor_update(x, c, alpha=(1 - eps) / n,
                                            beta=eps),
                      lambda: factor_update_ref(x, c, alpha=(1 - eps) / n,
                                                beta=eps),
                      lambda: torch.addmm(c, x.T, x, beta=0.95,
                                          alpha=0.05 / n)),
            bound=bound_ms(float(n) * d * (d + 1), 4.0 * (n * d + 2 * d * d)))
        row["cases"][label.split()[0]] = case
        print(f"  factor_update {label} X({n},{d}): {case['plan']}; device "
              f"{fmt_ms(case['ms'])} ms, plain {fmt_ms(case['plain_ms'])}, "
              f"addmm {fmt_ms(case['library_ms'])}; bound "
              f"{case['bound'][0]:.4f} ({case['bound'][1]}; "
              f"{case['bound'][0] / case['ms']:.1%})")
    row["max_abs_err"] = max(row["max_abs_err"], *errs)


def conv_main(label: str, cfg, steps: int = AE_STEPS) -> dict:
    """``Trainer.fit`` of the full-width conv classifier (32×32×3 images,
    convs (32, 3, 1), (32, 3, 2), (64, 3, 2), 10 classes; N = 512 a step)
    on one path, the launch counters zeroed just before and read just
    after: exact counts (``kfac_launches`` over its 4 layers), the loss
    finite and its last value under ``(1 − CONV_LOSS_MARGIN)·ln 10`` (the
    data alone moves a step's loss by ~0.05 about ln 10), per-step host
    times of ``opt.update``, the accuracy, peak memory."""
    from repro_torch.configs.conv_classifier import CONFIG as CONV
    from repro_torch.optimizers.kfac import kfac
    net, params, data = conv_model(CONV, "cuda")
    opt = kfac(net, cfg, family="categorical", device="cuda")
    if cfg.fused_stats and opt.engine.fused_names != set(net.metas):
        raise AssertionError(f"conv {label}: fused layers "
                             f"{opt.engine.fused_names}")
    want = kfac_launches(cfg, len(net.metas), steps)
    out, step_ms, launches, peak, resident = fit_timed(opt, net, params,
                                                       data, steps)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    acc = [h["accuracy"] for h in hist]
    plain = sorted(t for i, t in enumerate(step_ms)
                   if i not in (0, AE_SWEEP, *AE_REFRESH))
    print(f"[conv:{label}] full width {CONV.image_size}x{CONV.image_size}x"
          f"{CONV.channels}, convs {list(CONV.conv)}, N={CONV_N}, {steps} "
          f"steps, {net.n_params()} parameters")
    print(f"  per-step ms: {[round(t, 3) for t in step_ms]}")
    print(f"  plain-step median {plain[len(plain) // 2]:.3f}; refresh "
          f"steps {[round(step_ms[i], 3) for i in AE_REFRESH]}; sweep step "
          f"{step_ms[AE_SWEEP]:.3f}; peak memory {peak / 2 ** 20:.1f} MiB, "
          f"of which {resident / 2 ** 20:.1f} MiB was allocated before")
    print(f"  losses: first {losses[0]:.4f}, last {losses[-1]:.4f}; "
          f"accuracy first {acc[0]:.4f}, last {acc[-1]:.4f}")
    print(f"  launches: {launches}")
    ceiling = (1.0 - CONV_LOSS_MARGIN) * math.log(CONV.n_classes)
    if (not all(math.isfinite(v) for v in losses)
            or not losses[-1] < ceiling):
        raise AssertionError(f"conv {label}: loss not finite or its last "
                             f"value not under {ceiling:.4f}: {losses}")
    if launches != want:
        raise AssertionError(f"conv {label}: launch counts {launches}, "
                             f"expected {want}")
    return {"steps": steps, "n_images": CONV_N, "step_ms": step_ms,
            "plain_step_ms_median": plain[len(plain) // 2],
            "refresh_step_ms": {i: step_ms[i] for i in AE_REFRESH},
            "sweep_step_ms": step_ms[AE_SWEEP], "peak_mem_bytes": peak,
            "resident_bytes_before": resident, "losses": losses,
            "accuracy": acc, "launches": launches}


def fused_first_pass(label: str, mlp, params, data) -> float:
    """One statistics pass of the full-width autoencoder from the initial
    state, two-pass and with ``fused_stats``, same uniforms: every factor
    within 1e-5 of max|two-pass factor| (the same kernel sums the same
    rows; only the blend's rounding differs).  Returns the largest
    relative difference."""
    from repro_torch.optimizers.kfac import KFACEngine
    from repro_torch.training.trainer import seeded_noise
    cfg = ae_paths()[label]
    batch = data.batch(0)
    noise = seeded_noise(0, "cuda")
    factors = []
    for fused in (False, True):
        eng = KFACEngine(mlp, dataclasses.replace(cfg, fused_stats=fused),
                         family="bernoulli", device="cuda")
        state = eng.init(params, batch)
        state, _, _ = eng.stats_grads(state, params, batch,
                                      lambda shape: noise(0, shape))
        factors.append(state.factors)
    worst = 0.0
    for name, two in factors[0].items():
        for side in ("a", "g"):
            want, got = two[side], factors[1][name][side]
            rel = ((got - want).abs().max() / want.abs().max()).item()
            worst = max(worst, rel)
            if not rel <= 1e-5:
                raise AssertionError(f"fused {label} {name}.{side}: "
                                     f"{rel:.3e} of the two-pass factor")
    print(f"[conv:ae_fs_{label}] first statistics pass, fused against "
          f"two-pass factors: max relative difference {worst:.3e}")
    return worst


def fused_trajectory(label: str, fused: list, two: list) -> float:
    """The full-width autoencoder's 25 losses with ``fused_stats`` against
    phase 5's two-pass run of the path: equal at step 0 (the same
    parameters), then queue C's limit of ROADMAP (5e-3 relative through
    step 19, 2% after).  Returns the largest relative difference."""
    worst = 0.0
    for step, (a, b) in enumerate(zip(fused, two)):
        rel = abs(a - b) / abs(b)
        worst = max(worst, rel)
        lim = 0.0 if step == 0 else 5e-3 if step < 20 else 2e-2
        if not rel <= lim:
            raise AssertionError(f"fused {label}: step {step} loss {a} vs "
                                 f"two-pass {b} ({rel:.3e} > {lim:g})")
    print(f"[conv:ae_fs_{label}] 25 losses against phase 5's two-pass run: "
          f"max relative difference {worst:.3e}")
    return worst


# ---- the "decoders" phase: K-FAC training of the dense decoders ----------

DEC_STEPS = {"smollm-135m": 25, "llama3.2-1b": 6}
DEC_ROWS = 8 * 64             # the launcher's global N: B·T tokens
DEC_STACK = 16                # llama3.2-1b's stacked layers
# llama3.2-1b's three stacked factor-side widths: d_model (and the query
# and output maps), d_ff and the K/V maps' output
DEC_SIDES = (2048, 8192, 512)
DEC_NS = (8192, 2048)


def decoder_metas(arch: str, cfg=None) -> dict:
    """The full-width decoder's K-FAC layer metas (no weights are built);
    ``cfg``: the arch's config cut in depth."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    return LM(cfg or get_config(arch), device="cpu").metas


def side_floats(d: int, kind: str, nb: int) -> int:
    """The floats of one factor side of width ``d``: d² (full), nb·db²
    (block: nb diagonal (db, db) blocks) or d (diag)."""
    if kind == "diag":
        return d
    return nb * (d // nb) ** 2


def decoder_memory(arch: str, cfg=None) -> dict:
    """The device memory a full-width decoder's K-FAC run holds, reckoned
    from the code (GiB): P a float32 copy of the parameters, F the factors
    (as much again for the inverses; a block side holds nb·db² floats),
    L its largest stacked side, (S, d, d) or a block side's (S·nb, db,
    db), I the identity views ``init`` holds before the first refresh (one
    (d, d), or (db, db), a side), H(m) the exact-Fisher quadratic's head
    terms for m tangents: the tied head's tangents (m, d, V), and about 4m
    (B·T, V) arrays of the logits' J-products and the contractions'
    copies.  Factors and inverses are
    written over the old ones (``optimizers/kfac.py::Written``), so one
    set of each lives.  A refresh holds params, delta0 and grads (3P),
    factors, inverses and Newton–Schulz's four (S, d, d) stacks at the
    widest side: M, X, Z = M X and the new X.  An update holds params, the
    trainer's old delta0, grads, the regularized gradient, the
    preconditioned step, the scaled one and the applied one (7P; the new
    params come once the scaled one is gone), factors, inverses, H(2), and
    at step 0 also ``init``'s identities.  The γ sweep's refresh holds the
    three candidates' inverses beside the current set and NS's four
    stacks three times over; its update three candidate steps, the
    picked one and its scaled and applied copies (10P), the candidates',
    the picked and the current inverses (5F) beside the factors, and
    H(4).  Eigen mode (EKFAC) holds no inverses: bases as large as the
    factors (B, no basis on a diagonal side) and ``s`` and ``damp``, each
    as large as the tagged weights (2T).  Its refresh holds params, delta0
    and grads, the factors, the eigen states and eigh's symmetrized copy,
    new basis and the entry it replaces at the widest side (3P + F + B +
    2T + 3L); its update the 7P, the factors and eigen states, H(2) and
    at step 0 ``init``'s identity views.  The γ sweep's refresh adds the
    candidates' bases, ``s`` and three ``damp`` (B + 4T); its update the
    10P, H(4), the candidates and the picked state (B + 2T).  The fused
    fixed-lr chain (``use_rescale=False``) updates without the quadratic
    model: params, the trainer's old delta0, grads, the regularized
    gradient, the velocity and the new params (6P) beside factors,
    inverses and ``init``'s identities; at a sweep, the three candidates'
    inverses as well.  ``cfg``: the arch's config cut in depth."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = cfg or get_config(arch)
    lm = LM(cfg, device="cpu")
    gib = 4 / 2 ** 30
    p = lm.n_params() * gib
    sides = [(m.n_stack or 1, d, kind, nb) for m in lm.metas.values()
             for d, kind, nb in ((m.a_dim, m.a_kind, m.a_blocks),
                                 (m.g_dim, m.g_kind, m.g_blocks))]
    f = sum(s * side_floats(d, kind, nb) for s, d, kind, nb in sides) * gib
    big = max(s * side_floats(d, kind, nb) for s, d, kind, nb in sides
              if kind != "diag") * gib
    ident = sum(d if kind == "diag" else (d // nb) ** 2
                for _, d, kind, nb in sides) * gib
    bases = sum(s_ * side_floats(d, kind, nb) for s_, d, kind, nb in sides
                if kind != "diag") * gib
    tagged = sum((m.n_stack or 1) * m.a_dim * m.g_dim
                 for m in lm.metas.values()) * gib
    head = lambda m: m * cfg.vocab_size * (cfg.d_model + 4 * DEC_ROWS) * gib
    eig = bases + 2 * tagged
    out = {"params_gib": p, "factors_gib": f, "largest_stack_gib": big,
           "identity_gib": ident, "quad_head_gib": head(2),
           "bases_gib": bases, "s_damp_gib": 2 * tagged,
           "refresh_gib": 3 * p + 2 * f + 4 * big,
           "update_gib": 7 * p + 2 * f + head(2) + ident,
           "sweep_refresh_gib": 3 * p + 5 * f + 12 * big,
           "sweep_update_gib": 10 * p + 6 * f + head(4),
           "eigen_refresh_gib": 3 * p + f + eig + 3 * big,
           "eigen_update_gib": 7 * p + f + eig + head(2) + ident,
           "eigen_sweep_refresh_gib": (3 * p + f + eig + bases + 4 * tagged
                                       + 3 * big),
           "eigen_sweep_update_gib": (10 * p + f + eig + 2 * bases
                                      + 6 * tagged + head(4)),
           "chain_update_gib": 6 * p + 2 * f + ident,
           "chain_sweep_update_gib": 6 * p + 5 * f}
    label = (arch if cfg.n_layers == get_config(arch).n_layers
             else f"{arch} at {cfg.n_layers} layers")
    print(f"[memory:{label}] reckoned: P {p:.2f}, F {f:.2f}, L {big:.2f}, "
          f"I {ident:.2f}, H(2) {head(2):.2f} GiB; refresh "
          f"{out['refresh_gib']:.1f}, update (step 0) {out['update_gib']:.1f}"
          f", γ sweep's refresh {out['sweep_refresh_gib']:.1f} and update "
          f"{out['sweep_update_gib']:.1f} GiB; eigen: B {bases:.2f}, 2T "
          f"{2 * tagged:.2f}, refresh {out['eigen_refresh_gib']:.1f}, "
          f"update (step 0) {out['eigen_update_gib']:.1f}, γ sweep's "
          f"refresh {out['eigen_sweep_refresh_gib']:.1f} and update "
          f"{out['eigen_sweep_update_gib']:.1f} GiB; the fixed-lr chain's "
          f"update {out['chain_update_gib']:.1f} (sweep "
          f"{out['chain_sweep_update_gib']:.1f}) GiB")
    return out


def reckoned_peak(reckoned: dict, kcfg, sweeps: bool) -> float:
    """The largest of ``decoder_memory``'s stages that a run under
    ``kcfg`` passes through (``sweeps``: it reaches a γ sweep)."""
    if kcfg.inv_mode == "eigen":
        keys = ("eigen_refresh_gib", "eigen_update_gib") + (
            ("eigen_sweep_refresh_gib", "eigen_sweep_update_gib")
            if sweeps else ())
    elif not kcfg.use_rescale:
        keys = ("refresh_gib", "chain_update_gib") + (
            ("sweep_refresh_gib", "chain_sweep_update_gib") if sweeps else ())
    else:
        keys = ("refresh_gib", "update_gib") + (
            ("sweep_refresh_gib", "sweep_update_gib") if sweeps else ())
    return max(reckoned[k] for k in keys)


def memory_table() -> dict:
    """``decoder_memory`` of every trained decoder at full width, and of
    gemma2-2b at the depth its card run keeps (CPU only, no weights)."""
    return {"smollm-135m": decoder_memory("smollm-135m"),
            "llama3.2-1b": decoder_memory("llama3.2-1b"),
            "gemma2-2b": decoder_memory("gemma2-2b"),
            f"gemma2-2b@{G2_LAYERS}": decoder_memory("gemma2-2b",
                                                     gemma2_cfg())}


def decoder_kernel_rows(dev, rows: dict) -> None:
    """The kernels at full-width llama3.2-1b's shapes, each against its
    plain version as phase 3 holds it (the errors fold into each row's
    ``max_abs_err``), timed beside the library calls with plans and bounds
    as cases ``llama3.2-1b ...`` of rows 2, 3 and 4:

    * factor_update batched over the 16 stacked layers, X (16, 512, d) into
      (16, d, d) for d in 2048, 8192 and 512, at beta = 0 and 0.95, timed
      once at each width beside baddbmm;
    * one ns_step on (16, 8192, 8192) and on (16, 2048, 2048) stacks (the
      MLP's and the attention's factors), beside bmm + baddbmm;
    * precondition on each of the 7 stacked layer shapes (a, g) of one
      step, Ā⁻¹ (16, a, a), V (16, a, g), Ḡ⁻¹ (16, g, g), beside bmm +
      bmm.

    A (16, 8192, 8192) float32 stack is 2³⁰ elements (4 GiB): the largest
    tensor any kernel has met, so its timings repeat twice, not ten
    times."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.factor_update import (factor_update,
                                                   factor_update_ref)
    from repro_torch.kernels.ns_step import ns_step, ns_step_ref
    from repro_torch.kernels.precond import precondition, precondition_ref
    g = torch.Generator(device=dev).manual_seed(11)
    sms = gemm_plan.sm_count(dev.index or 0)
    eps = torch.tensor(0.95, device=dev)

    def spd(d):
        f = torch.randn(DEC_STACK, d, 512, generator=g, device=dev)
        m = torch.bmm(f, f.transpose(1, 2)) / 512
        return m + 0.1 * torch.eye(d, device=dev)

    errs = []
    ops, flops, nbytes, plans = [], 0.0, 0.0, []
    for d in DEC_SIDES:
        x = torch.tanh(torch.randn(DEC_STACK, DEC_ROWS, d, generator=g,
                                   device=dev))
        c = spd(d)
        for e in (0.0, 0.95):
            be = torch.tensor(e, device=dev)
            a = (1 - be) / DEC_ROWS
            prod = factor_update_ref(x, c, alpha=a, beta=0.0)
            compare(f"factor_update llama X({DEC_STACK},{DEC_ROWS},{d}) "
                    f"beta={e}", factor_update(x, c, alpha=a, beta=be),
                    factor_update_ref(x, c, alpha=a, beta=be), errs,
                    scale=prod.abs().max().item())
            del prod
        p = gemm_plan.triangle_plan(d, d, False, DEC_ROWS, sms,
                                    batch=DEC_STACK)
        plans.append(f"d {d}: tile {p.tile}, {p.tiles} tiles a side, "
                     f"{p.blocks} blocks, splits {p.splits}")
        ops.append((x, c))
        flops += float(DEC_STACK) * DEC_ROWS * d * (d + 1)
        nbytes += 4.0 * DEC_STACK * (DEC_ROWS * d + 2 * d * d)
    run = lambda f: [f(x, c, alpha=(1 - eps) / DEC_ROWS, beta=eps)
                     for x, c in ops]
    fu = rows["factor_update"]
    fu["cases"]["llama3.2-1b"] = dict(
        unit="llama3.2-1b's stacked factor side widths, one launch each: X "
             + ", ".join(f"({DEC_STACK}, {DEC_ROWS}, {d})"
                         for d in DEC_SIDES),
        plans=plans,
        **timings(lambda: run(factor_update), lambda: run(factor_update_ref),
                  lambda: [torch.baddbmm(c, x.transpose(1, 2), x, beta=0.95,
                                         alpha=0.05 / DEC_ROWS)
                           for x, c in ops], reps=3),
        bound=bound_ms(flops, nbytes))
    fu["max_abs_err"] = max(fu["max_abs_err"], *errs)
    del ops, x, c
    torch.cuda.empty_cache()

    errs = []
    for d in DEC_NS:
        m = spd(d)
        x0 = torch.eye(d, device=dev) / m.abs().sum(-1).amax(-1)[:, None,
                                                                  None]
        x = ns_step_ref(m, x0)
        del x0
        compare(f"ns_step llama stacked ({DEC_STACK},{d},{d})",
                ns_step(m, x), ns_step_ref(m, x), errs)
        rows["ns_step"]["cases"][f"llama3.2-1b {d}"] = dict(
            unit=f"one stacked ns_step, M and X ({DEC_STACK}, {d}, {d})",
            plans=[mm_plan(DEC_STACK, d, d, d)],
            **timings(lambda: ns_step(m, x), lambda: ns_step_ref(m, x),
                      lambda: torch.baddbmm(x, x, torch.bmm(m, x), beta=2,
                                            alpha=-1),
                      reps=2 if d > 4096 else 10),
            bound=bound_ms(4.0 * DEC_STACK * d ** 3,
                           4.0 * DEC_STACK * 3 * d * d))
        del m, x
        torch.cuda.empty_cache()
    rows["ns_step"]["max_abs_err"] = max(rows["ns_step"]["max_abs_err"],
                                         *errs)

    errs, ops, plans = [], [], []
    shapes = [(m.d_in, m.d_out) for m in decoder_metas("llama3.2-1b").values()
              if m.kind == "dense"]
    for a, gd in shapes:
        ai, gi = spd(a), spd(gd)
        v = torch.randn(DEC_STACK, a, gd, generator=g, device=dev)
        compare(f"precondition llama stacked a={a} g={gd}",
                precondition(ai, v, gi), precondition_ref(ai, v, gi), errs)
        ops.append((ai, v, gi))
        plans += [mm_plan(DEC_STACK, a, gd, k_) for k_ in (gd, a)]
    pc = rows["precondition"]
    pc.setdefault("cases", {})["llama3.2-1b"] = dict(
        unit="the 7 stacked layers of one llama3.2-1b step, Ā⁻¹ V Ḡ⁻¹ at "
             + ", ".join(f"({DEC_STACK}, {a}, {gd})" for a, gd in shapes),
        plans=plans,
        **timings(lambda: [precondition(*o) for o in ops],
                  lambda: [precondition_ref(*o) for o in ops],
                  lambda: [torch.bmm(ai, torch.bmm(v, gi))
                           for ai, v, gi in ops], reps=2),
        bound=bound_ms(sum(2.0 * DEC_STACK * a * gd * (a + gd)
                           for a, gd in shapes),
                       4.0 * DEC_STACK * sum(a * a + 2 * a * gd + gd * gd
                                             for a, gd in shapes)))
    pc["max_abs_err"] = max(pc["max_abs_err"], *errs)
    del ops
    torch.cuda.empty_cache()
    for label, r in [("factor_update", fu["cases"]["llama3.2-1b"]),
                     ("precondition", pc["cases"]["llama3.2-1b"])] + [
            ("ns_step", rows["ns_step"]["cases"][f"llama3.2-1b {d}"])
            for d in DEC_NS]:
        print(f"  {label} {r['unit']}: kernel {r['ms']:.4f} "
              f"[{r['eager_ms']['ms']:.4f}] ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; "
              f"{r['bound'][0] / r['ms']:.1%}); plans {r['plans']}")


def lm_launches(kcfg, metas: dict, stop: int, start: int = 0) -> dict:
    """The launch counts of steps ``start`` to ``stop`` of an LM's K-FAC
    run under ``kcfg`` (serial refresh), from its layer metas.  A
    statistics step launches factor_update on both sides of each
    full/full or block layer (``DenseKronecker``, ``BlockDiagKronecker``;
    a stacked layer's sides one batched launch each) and on the G side of
    each 1-D conv stem, whose A side is one patch_factor; ``fused_stats``
    launches the same, moved into the passes.  The diagonal-side blocks
    (the embedding, whisper's head) launch nothing.  blkdiag refreshes at
    the first three steps and every T3, and at the γ sweep every T2: ns_step
    on every full or block factor side ``ns_iters`` times (the sweep's
    candidates in the same launches); eigen mode refreshes by eigh (no
    kernel).  An apply a step, three at a sweep with the exact-F
    rescale (the chain applies candidate 0 only): a full/full layer
    launches precondition (blkdiag), rotate_rescale (eigen, with or without
    the chain) or precond_momentum (the blkdiag chain); a layer with a
    block side launches matmul, two an apply (blkdiag, either way) or four
    (eigen: each rotation a side).  Each ns_step and precondition is two
    matmul launches, each rotate_rescale three and a matmul_rescale, each
    precond_momentum one and an axpy_momentum.  tridiag on an LM is
    blkdiag."""
    from repro_torch import kernels as K
    steps = range(start, stop)
    sweeps = [s for s in steps if kcfg.t2 > 0 and s > 0 and s % kcfg.t2 == 0]
    refresh = [s for s in steps if s not in sweeps
               and (s - start < 3 or s % kcfg.t3 == 0)]
    stats = len([s for s in steps if s % kcfg.stats_period == 0])
    ms = list(metas.values())
    kron = [m for m in ms if m.kind in ("dense", "conv")
            and "diag" not in (m.a_kind, m.g_kind)]
    blocked = [m for m in kron if "block" in (m.a_kind, m.g_kind)]
    full = len(kron) - len(blocked)
    convs = len([m for m in ms if m.kind == "conv"])
    sides = sum((m.a_kind != "diag") + (m.g_kind != "diag") for m in ms)
    eigen = kcfg.inv_mode == "eigen"
    applies = len(steps) + (2 * len(sweeps) if kcfg.use_rescale else 0)
    ns = 0 if eigen else (len(refresh) + len(sweeps)) * sides * kcfg.ns_iters
    want = dict({name: 0 for name in K.WRAPPERS}, ns_step=ns,
                factor_update=(2 * len(kron) - convs) * stats,
                patch_factor=convs * stats)
    if eigen:
        want.update(rotate_rescale=full * applies,
                    matmul_rescale=full * applies)
        mm = 3 * full * applies + 4 * len(blocked) * applies
    elif kcfg.use_rescale:
        want.update(precondition=full * applies)
        mm = 2 * full * applies + 2 * len(blocked) * applies
    else:
        want.update(precond_momentum=full * applies,
                    axpy_momentum=full * applies)
        mm = full * applies + 2 * len(blocked) * applies
    want["matmul"] = mm + 2 * ns
    return want


def decoder_main(arch: str, steps: int, falling: bool = True,
                 cfg=None, kfac_kw=None, label=None, keep=None,
                 base_peak_gib=None) -> dict:
    """``Trainer.fit`` of a full-width LM through ``launch/train.py``'s
    ``main`` at the launcher's defaults (batch 8, seq 64, λ₀ 10, T3 5,
    blkdiag NS; weights from seed 0), the launch counters zeroed just
    before and read just after: exact counts (``lm_launches``), every
    loss finite and every update applied (a finite, nonzero step), with
    ``falling`` the last loss below the first; plain-step, refresh-step
    and sweep-step ms of ``opt.update``, each step's λ, α, μ and ρ, peak
    memory beside ``decoder_memory``'s reckoning of the path, and the
    memory allocated, reserved and free on the device before the run.
    ``cfg``: the arch's config cut in depth, given to ``main``;
    ``kfac_kw``: ``KFACConfig`` fields (``inv_mode`` goes on the command
    line as ``--inv_mode``, the others through ``main``'s ``kfac_kw``);
    ``label``: the run's name in the output; ``keep``: a dict that gets
    the run's result and optimizer; ``base_peak_gib``: a measured peak
    that stands for the reckoning's non-K-FAC part (whisper's
    activations), to which the eigen state's ``s`` and ``damp`` are
    added."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import KFACConfig
    from repro_torch.launch import train

    mcfg = cfg
    name = label or arch
    kw = dict(kfac_kw or {})
    mode = kw.pop("inv_mode", "blkdiag")
    cfg = KFACConfig(lambda_init=10.0, t3=5, inv_mode=mode, **kw)
    reckoned = decoder_memory(arch, mcfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    free, total = torch.cuda.mem_get_info()
    print(f"[main:{name}] before the run: allocated "
          f"{resident / 2 ** 20:.1f} MiB, reserved {reserved / 2 ** 20:.1f} "
          f"MiB, free {free / 2 ** 20:.1f} of {total / 2 ** 20:.1f} MiB")
    K.reset_launches()
    ms, held = [], {}

    def wrap(opt):
        held["opt"] = opt
        return timed(opt, ms)

    t0 = time.perf_counter()
    res = train.main(["--arch", arch, "--steps", str(steps), "--inv_mode",
                      mode], log=lambda msg: print(f"  {msg}"),
                     wrap_opt=wrap, cfg=mcfg, kfac_kw=kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches()
    peak = torch.cuda.max_memory_allocated()
    want = lm_launches(cfg, decoder_metas(arch, mcfg), steps)
    losses = [h["loss"] for h in res["history"]]
    sweeps = [i for i in range(steps) if i > 0 and i % cfg.t2 == 0]
    refresh = [i for i in range(steps)
               if i not in sweeps and (i < 3 or i % cfg.t3 == 0)]
    plain = sorted(t for i, t in enumerate(ms)
                   if i not in refresh and i not in sweeps)
    rpeak = reckoned_peak(reckoned, cfg, bool(sweeps))
    if base_peak_gib is not None:
        rpeak = base_peak_gib + (reckoned["s_damp_gib"]
                                 if mode == "eigen" else 0.0)
    depth = "" if mcfg is None else f" at {mcfg.n_layers} layers"
    print(f"[main:{name}] full-width {arch}{depth}, batch 8, seq 64, "
          f"inv_mode {mode} {kw or ''}, {steps} steps in {wall:.1f} s")
    print(f"  per-step ms: {[round(t, 1) for t in ms]}")
    print(f"  plain-step median {plain[len(plain) // 2]:.1f} ms; refresh "
          f"steps {[round(ms[i], 1) for i in refresh]} ms (step 0 includes "
          f"the first calls' set-up); sweep steps "
          f"{[round(ms[i], 1) for i in sweeps]} ms; peak memory "
          f"{peak / 2 ** 20:.1f} MiB, of which {resident / 2 ** 20:.1f} MiB "
          f"was allocated before (the run's {(peak - resident) / 2 ** 30:.2f}"
          f" GiB against {rpeak:.2f} reckoned, "
          f"{(peak - resident) / 2 ** 30 / rpeak - 1:+.1%})")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    model = {k: [h.get(k) for h in res["history"]]
             for k in ("lam", "alpha", "mu", "rho", "delta_norm")}
    for k, vs in model.items():
        print(f"  {k}: {[None if v is None else float(f'{v:.4g}') for v in vs]}")
    print(f"  launches: {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: loss not finite: {losses}")
    if not all(math.isfinite(v) and v > 0 for v in model["delta_norm"]):
        raise AssertionError(f"{name}: an update not applied: "
                             f"{model['delta_norm']}")
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss not falling: {losses}")
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, expected "
                             f"{want}")
    out = {"steps": steps, "n_tokens": DEC_ROWS, "step_ms": ms,
           "inv_mode": mode, "kfac_kw": kw,
           "reckoned": reckoned, "reckoned_peak_gib": rpeak,
           **model,
           "plain_step_ms_median": plain[len(plain) // 2],
           "refresh_step_ms": {i: ms[i] for i in refresh},
           "sweep_step_ms": {i: ms[i] for i in sweeps},
           "peak_mem_bytes": peak, "resident_bytes_before": resident,
           "reserved_bytes_before": reserved, "free_bytes_before": free,
           "losses": losses, "launches": launches, "wall_s": wall}
    if keep is not None:
        keep.update(res=res, opt=held["opt"])
    del res
    torch.cuda.empty_cache()
    return out


def decoders_phase(dev, rows: dict) -> dict:
    """The "decoders" phase: the kernels at llama3.2-1b's shapes
    (``decoder_kernel_rows``), reduced smollm-135m and llama3.2-1b 4 steps
    on the card and on the CPU, full-width smollm-135m 25 steps (through
    the step-20 γ sweep) and 3 Adam steps, full-width llama3.2-1b 6 steps
    (the warmup refreshes, the λ step at 4, the T3 refresh at 5).  Alone:
    ``python3 -c 'import chip_smoke as c, torch; c.decoders_phase(
    torch.device("cuda"), c.kernel_rows_stub())'``."""
    t0 = time.perf_counter()
    decoder_kernel_rows(dev, rows)
    out = {"agree": {arch: agree_lm(arch) for arch in DEC_STEPS}}
    out["smollm-135m"] = decoder_main("smollm-135m",
                                      DEC_STEPS["smollm-135m"])
    out["smollm-135m_adam"] = lm_adam("smollm-135m")
    # llama3.2-1b's loss is held finite, not falling: 6 steps on the
    # synthetic stream, 512 tokens a step over a vocab of 128,256, leave it
    # near its first value (12.1275 to 12.1763 on an H100 80GB HBM3 at
    # 700 W), and the port follows the reference at that vocab
    # (tests/test_torch_decoder_vocab.py)
    out["llama3.2-1b"] = decoder_main("llama3.2-1b",
                                      DEC_STEPS["llama3.2-1b"],
                                      falling=False)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---- the "gemma2" phase: block-diagonal factors, gemma2-2b's training ------

G2_LAYERS = 12                # gemma2-2b cut in depth: 6 local/global pairs
G2_STEPS = 6                  # the warmup refreshes, a plain step, T3 at 5
G2_STACK = G2_LAYERS // 2     # each pattern position's stacked layers
G2_MFD = (64, 48)             # the reduced runs' max_factor_dim
# full sides' widths: d_model, the query and output maps, the K/V maps'
# output; the d_ff side of 9216 is two blocks of 4608
G2_FULL = (2304, 2048, 1024)
G2_BLOCK = (2, 4608)


def gemma2_cfg():
    """gemma2-2b at full width, cut to ``G2_LAYERS`` layers: the whole
    model does not fit one card (``decoder_memory("gemma2-2b")``)."""
    from repro_torch.configs import get_config
    return get_config("gemma2-2b").replace(n_layers=G2_LAYERS)


def gemma2_kernel_rows(dev, rows: dict) -> None:
    """The kernels at the 12-layer gemma2-2b's shapes, each against its
    plain version as phase 3 holds it (the errors fold into each row's
    ``max_abs_err``), timed beside the library calls with plans and bounds
    as cases ``gemma2-2b ...`` of rows 1-4:

    * factor_update on the block side's rows folded block-major, X (12,
      512, 4608) into (12, 4608, 4608) (S·nb = 6·2), and on the full
      sides' (6, 512, d), d 2304, 2048 and 1024, at beta = 0 and 0.95,
      timed as one unit (a step's four widths) beside baddbmm;
    * one ns_step on the block stack (12, 4608, 4608) and on (6, 2304,
      2304), beside bmm + baddbmm;
    * the apply of the 7 stacked layers of one step through their curvature
      blocks (``BlockDiagKronecker.precondition``: one matmul a side, the
      block axis in the batch, on gate, up and down; ``precondition`` on
      the attention's four), against ``core/inverse.py::
      apply_block_inverse`` (the reference's order, plain products) and
      beside bmm / batched matmul calls."""
    from repro_torch.configs.base import KFACConfig
    from repro_torch.core import inverse as INV
    from repro_torch.core.blocks import resolve
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.factor_update import (factor_update,
                                                   factor_update_ref)
    from repro_torch.kernels.ns_step import ns_step, ns_step_ref
    g = torch.Generator(device=dev).manual_seed(12)
    sms = gemm_plan.sm_count(dev.index or 0)
    eps = torch.tensor(0.95, device=dev)
    nb, db = G2_BLOCK

    def spd(lead, d):
        f = torch.randn(*lead, d, 512, generator=g, device=dev)
        m = f @ f.transpose(-1, -2) / 512
        return m + 0.1 * torch.eye(d, device=dev)

    errs, ops, flops, nbytes, plans = [], [], 0.0, 0.0, []
    widths = [(G2_STACK * nb, db)] + [(G2_STACK, d) for d in G2_FULL]
    for batch, d in widths:
        x = torch.tanh(torch.randn(batch, DEC_ROWS, d, generator=g,
                                   device=dev))
        c = spd((batch,), d)
        for e in (0.0, 0.95):
            be = torch.tensor(e, device=dev)
            a = (1 - be) / DEC_ROWS
            prod = factor_update_ref(x, c, alpha=a, beta=0.0)
            compare(f"factor_update gemma2 X({batch},{DEC_ROWS},{d}) "
                    f"beta={e}", factor_update(x, c, alpha=a, beta=be),
                    factor_update_ref(x, c, alpha=a, beta=be), errs,
                    scale=prod.abs().max().item())
            del prod
        p = gemm_plan.triangle_plan(d, d, False, DEC_ROWS, sms, batch=batch)
        plans.append(f"({batch}, {DEC_ROWS}, {d}): tile {p.tile}, "
                     f"{p.tiles} tiles a side, {p.blocks} blocks, splits "
                     f"{p.splits}")
        ops.append((x, c))
        flops += float(batch) * DEC_ROWS * d * (d + 1)
        nbytes += 4.0 * batch * (DEC_ROWS * d + 2 * d * d)
    run = lambda f: [f(x, c, alpha=(1 - eps) / DEC_ROWS, beta=eps)
                     for x, c in ops]
    fu = rows["factor_update"]
    fu["cases"]["gemma2-2b"] = dict(
        unit=f"the {G2_LAYERS}-layer gemma2-2b's stacked factor sides, one "
             "launch each: X " + ", ".join(f"({b}, {DEC_ROWS}, {d})"
                                           for b, d in widths)
             + f" (the first: the d_ff side's {nb} blocks of {db} in the "
             "batch)",
        plans=plans,
        **timings(lambda: run(factor_update), lambda: run(factor_update_ref),
                  lambda: [torch.baddbmm(c, x.transpose(1, 2), x, beta=0.95,
                                         alpha=0.05 / DEC_ROWS)
                           for x, c in ops], reps=3),
        bound=bound_ms(flops, nbytes))
    fu["max_abs_err"] = max(fu["max_abs_err"], *errs)
    del ops, x, c
    torch.cuda.empty_cache()

    errs = []
    for batch, d in ((G2_STACK * nb, db), (G2_STACK, G2_FULL[0])):
        m = spd((batch,), d)
        x0 = torch.eye(d, device=dev) / m.abs().sum(-1).amax(-1)[:, None,
                                                                  None]
        x = ns_step_ref(m, x0)
        del x0
        compare(f"ns_step gemma2 stacked ({batch},{d},{d})",
                ns_step(m, x), ns_step_ref(m, x), errs)
        rows["ns_step"]["cases"][f"gemma2-2b {d}"] = dict(
            unit=f"one stacked ns_step, M and X ({batch}, {d}, {d})",
            plans=[mm_plan(batch, d, d, d)],
            **timings(lambda: ns_step(m, x), lambda: ns_step_ref(m, x),
                      lambda: torch.baddbmm(x, x, torch.bmm(m, x), beta=2,
                                            alpha=-1), reps=3),
            bound=bound_ms(4.0 * batch * d ** 3, 4.0 * batch * 3 * d * d))
        del m, x
        torch.cuda.empty_cache()
    rows["ns_step"]["max_abs_err"] = max(rows["ns_step"]["max_abs_err"],
                                         *errs)

    kcfg = KFACConfig()
    metas = [m for m in decoder_metas("gemma2-2b", gemma2_cfg()).values()
             if m.kind == "dense"]
    errs, ops, plans = [], [], []
    flops = nbytes = 0.0

    def inv_side(d, kind, nb_):
        return (spd((G2_STACK, nb_), d // nb_) if kind == "block"
                else spd((G2_STACK,), d))

    def library(meta, inv, v):
        """The apply in bmm / batched matmul calls: a block side's blocks
        as the batch of a strided view."""
        ai, gi = inv["a_inv"], inv["g_inv"]
        s_, a, gd = v.shape
        if meta.a_kind == "block":
            u = torch.bmm(ai.reshape(-1, *ai.shape[-2:]),
                          v.reshape(-1, a // meta.a_blocks, gd)).view(v.shape)
        else:
            u = torch.bmm(ai, v)
        if meta.g_kind == "block":
            k = meta.g_blocks
            return torch.matmul(u.view(s_, a, k, gd // k).transpose(1, 2),
                                gi).transpose(1, 2).reshape(v.shape)
        return torch.bmm(u, gi)

    for meta in metas:
        blk = resolve(meta)(meta, kcfg, dev)
        inv = {"a_inv": inv_side(meta.a_dim, meta.a_kind, meta.a_blocks),
               "g_inv": inv_side(meta.g_dim, meta.g_kind, meta.g_blocks)}
        v = torch.randn(G2_STACK, meta.a_dim, meta.g_dim, generator=g,
                        device=dev)
        want = INV.apply_block_inverse(meta, inv, v)
        compare(f"apply gemma2 {meta.name} ({type(blk).__name__})",
                blk.precondition(inv, v), want, errs)
        del want
        ops.append((meta, blk, inv, v))
        da = meta.a_dim // meta.a_blocks
        dg = meta.g_dim // meta.g_blocks
        a, gd = meta.a_dim, meta.g_dim
        plans += [mm_plan(G2_STACK * meta.a_blocks, da, gd, da),
                  mm_plan(G2_STACK * meta.g_blocks, a, dg, dg)]
        flops += 2.0 * G2_STACK * a * gd * (da + dg)
        nbytes += 4.0 * G2_STACK * (a * da + gd * dg + 2 * a * gd)
    pc = rows["precondition"]
    pc.setdefault("cases", {})["gemma2-2b"] = dict(
        unit=f"the 7 stacked layers of one {G2_LAYERS}-layer gemma2-2b "
             "step, Ā⁻¹ V Ḡ⁻¹ through their curvature blocks: "
             + ", ".join(f"{m.name.split('.', 1)[1]} ({G2_STACK}, {m.a_dim},"
                         f" {m.g_dim}) {m.a_kind}/{m.g_kind}"
                         for m, *_ in ops[:7])
             + "; a block side is one matmul launch with its "
             f"{nb} blocks of {db} in the batch",
        plans=plans,
        **timings(lambda: [b.precondition(i, v) for _, b, i, v in ops],
                  lambda: [INV.apply_block_inverse(m, i, v)
                           for m, _, i, v in ops],
                  lambda: [library(m, i, v) for m, _, i, v in ops], reps=3),
        bound=bound_ms(flops, nbytes))
    pc["max_abs_err"] = max(pc["max_abs_err"], *errs)
    rows["matmul"]["max_abs_err"] = max(rows["matmul"]["max_abs_err"],
                                        *errs)
    del ops
    torch.cuda.empty_cache()
    for label, r in [("factor_update", fu["cases"]["gemma2-2b"]),
                     ("apply", pc["cases"]["gemma2-2b"])] + [
            ("ns_step", rows["ns_step"]["cases"][f"gemma2-2b {d}"])
            for d in (db, G2_FULL[0])]:
        print(f"  {label} {r['unit']}: kernel {r['ms']:.4f} "
              f"[{r['eager_ms']['ms']:.4f}] ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; "
              f"{r['bound'][0] / r['ms']:.1%}); plans {r['plans']}")


def gemma2_phase(dev, rows: dict) -> dict:
    """The "gemma2" phase: the kernels at the 12-layer gemma2-2b's shapes
    (``gemma2_kernel_rows``); reduced gemma2-2b 4 steps on the card and on
    the CPU at ``max_factor_dim`` 64 and 48 (block sides); gemma2-2b at
    full width cut to 12 layers, 6 K-FAC steps through ``launch/train.py``
    (the warmup refreshes, a plain step, the λ step at 4, the T3 refresh
    at 5) with exact launches, its loss held finite, memory before and
    peak beside ``decoder_memory``'s reckoning, then 3 Adam steps.  Alone:
    ``python3 -c 'import chip_smoke as c, torch; c.gemma2_phase(
    torch.device("cuda"), c.kernel_rows_stub())'``."""
    t0 = time.perf_counter()
    memory_table()
    gemma2_kernel_rows(dev, rows)
    out = {"agree": {str(m): agree_lm("gemma2-2b", mfd=m) for m in G2_MFD}}
    # the loss is held finite, not falling: 6 steps of 512 tokens over a
    # vocab of 256,000 leave it near its first value, as llama3.2-1b's
    out["gemma2-2b"] = decoder_main("gemma2-2b", G2_STEPS, falling=False,
                                    cfg=gemma2_cfg())
    out["gemma2-2b_adam"] = lm_adam("gemma2-2b", cfg=gemma2_cfg())
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---- the "lm_eigen" phase: EKFAC, the fused chain, fused_stats, bundles ----

LE_SMOLLM_STEPS = 25          # through the γ sweep at step 20
LE_WHISPER_STEPS = 6          # the warmup refreshes, 2 plain, T3 at 5
LE_G2_STEPS = 6               # gemma2's eigen run, cut before its sweep
LE_MARGIN = 0.25              # the card's free memory an eigen cut leaves
LE_SMOLLM_STACK = 30          # smollm-135m's stacked layers
LE_WHISPER = ((12, 768, 3072), (12, 3072, 768))   # enc/dec MLP stacks
LE_PATHS = {                  # the reduced runs, cuda vs cpu
    "eigen": dict(inv_mode="eigen"),
    "chain": dict(use_rescale=False, fixed_momentum=0.9, kl_clip=1e-3),
    "fused_stats": dict(inv_mode="eigen", fused_stats=True)}
# whisper-small's blkdiag peak as the script's whisper phase measured it
# (NVIDIA H100 80GB HBM3, 700 W), for the phase run alone: the whole
# script measures its own
W_BLKDIAG_PEAK_MIB = 48178.0


def gemma2_eigen_layers(free_gib: float) -> int:
    """The deepest even cut of gemma2-2b whose eigen reckoning at step 0's
    update (``decoder_memory``) leaves ``LE_MARGIN`` of ``free_gib``."""
    from repro_torch.configs import get_config
    full = get_config("gemma2-2b")
    best = 0
    for n in range(2, full.n_layers + 1, 2):
        r = decoder_memory("gemma2-2b", full.replace(n_layers=n))
        if r["eigen_update_gib"] <= (1 - LE_MARGIN) * free_gib:
            best = n
    if not best:
        raise AssertionError(f"gemma2-2b: no eigen cut fits {free_gib:.1f}"
                             " GiB")
    return best


def _orthonormal(g, dev, *shape):
    """Orthonormal (d, d) bases over leading dims, as eigh returns."""
    return torch.linalg.qr(torch.randn(*shape, generator=g, device=dev))[0]


def lm_eigen_kernel_rows(dev, rows: dict, g2_layers: int) -> None:
    """The new shapes of this phase's kernels, each against its plain
    version (normwise 1e-4, ΣD² to relative 1e-4; the errors fold into
    each row's ``max_abs_err``), timed beside the library calls, as cases
    of their rows:

    * 6a, ``rotate_rescale`` batched: smollm-135m's 7 stacked layers (S =
      30), one call each; whisper-small's (12, 768, 3072) and (12, 3072,
      768) MLP stacks.  Library: bmm, div, bmm, bmm, bmm in the kernel's
      order.  Bound: 4·S·a·g·(a + g) operations; bytes: Q_A, Q_G, V, S
      read, U written, the two transposed copies written and read;
    * 6b, the block eigen apply of gemma2-2b's gate, up and down at the
      eigen run's depth (``BlockDiagKronecker.precondition_eigen``: four
      matmul launches, a block side's blocks in their batch), against
      ``core/inverse.py::apply_eigen``; library: bmm / batched matmul;
    * 5a, the batched chain ``precond_momentum`` and its
      ``axpy_momentum`` at smollm-135m's 7 stacked layers; library: bmm
      (T = V Ḡ⁻¹), baddbmm (α·Ā⁻¹T + μM), sum(d*d)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import KFACConfig
    from repro_torch.core import inverse as INV
    from repro_torch.core.blocks import resolve
    from repro_torch.kernels.rotate_rescale import (rotate_rescale,
                                                    rotate_rescale_ref)
    from repro_torch.kernels.update_chain import (axpy_momentum,
                                                  axpy_momentum_ref,
                                                  precond_momentum,
                                                  precond_momentum_ref)
    g = torch.Generator(device=dev).manual_seed(33)
    lam = torch.tensor(1e-12, device=dev)
    smollm = [(m.a_dim, m.g_dim) for m in decoder_metas(
        "smollm-135m").values() if m.kind == "dense"]
    S = LE_SMOLLM_STACK

    def rr_ops(shapes):
        return [(_orthonormal(g, dev, s_, a, a),
                 torch.randn(s_, a, gd, generator=g, device=dev),
                 _orthonormal(g, dev, s_, gd, gd),
                 torch.rand(s_, a, gd, generator=g, device=dev) + 0.05)
                for s_, a, gd in shapes]

    def rr_library(qa, v, qg, sd):
        t = torch.bmm(torch.bmm(qa.transpose(1, 2), v), qg).div_(sd)
        return torch.bmm(torch.bmm(qa, t), qg.transpose(1, 2))

    rr = rows["rotate_rescale"]
    rr.setdefault("cases", {})
    errs = []
    for case, shapes in (("smollm-135m", [(S, a, gd) for a, gd in smollm]),
                         ("whisper-small", list(LE_WHISPER))):
        ops = rr_ops(shapes)
        for (s_, a, gd), o in zip(shapes, ops):
            compare(f"rotate_rescale {case} ({s_},{a},{gd})",
                    rotate_rescale(*o, lam), rotate_rescale_ref(*o, lam),
                    errs)
        rr["cases"][case] = dict(
            unit=f"{case}'s stacked layers, one batched call each: "
                 + ", ".join(f"({s_}, {a}, {gd})" for s_, a, gd in shapes),
            plans=[mm_plan(s_, a, gd, k_) for s_, a, gd in shapes
                   for k_ in (a, a, gd)],
            **timings(lambda: [rotate_rescale(*o, lam) for o in ops],
                      lambda: [rotate_rescale_ref(*o, lam) for o in ops],
                      lambda: [rr_library(*o) for o in ops], reps=5),
            library_calls="bmm, bmm, div, bmm, bmm",
            bound=bound_ms(sum(4.0 * s_ * a * gd * (a + gd) + s_ * a * gd
                               for s_, a, gd in shapes),
                           4.0 * sum(s_ * (3 * a * a + 3 * gd * gd
                                           + 3 * a * gd)
                                     for s_, a, gd in shapes)))
        del ops
    rr["max_abs_err"] = max(rr["max_abs_err"], *errs)

    # 6b: the block eigen apply at the eigen run's depth
    cut = get_config("gemma2-2b").replace(n_layers=g2_layers)
    metas = [m for n, m in decoder_metas("gemma2-2b", cut).items()
             if ".mlp." in n]
    kcfg = KFACConfig(inv_mode="eigen")
    errs, ops, plans = [], [], []
    flops = nbytes = 0.0

    def basis(s_, d, kind, nb_):
        return (_orthonormal(g, dev, s_, nb_, d // nb_, d // nb_)
                if kind == "block" else _orthonormal(g, dev, s_, d, d))

    def library(meta, eig, v):
        """The eigen apply in bmm / batched matmul calls, a block side's
        blocks as the batch of a view."""
        def left(q, t):
            if meta.a_kind == "block":
                return torch.matmul(q, t.reshape(t.shape[0], meta.a_blocks,
                                                 -1, t.shape[-1])
                                    ).reshape(t.shape)
            return torch.bmm(q, t)

        def right(t, q):
            if meta.g_kind == "block":
                k = meta.g_blocks
                s_, a, gd = t.shape
                return torch.matmul(t.view(s_, a, k, gd // k).transpose(1, 2),
                                    q).transpose(1, 2).reshape(t.shape)
            return torch.bmm(t, q)

        qa, qg = eig["qa"], eig["qg"]
        t = right(left(qa.transpose(-1, -2), v), qg).div_(
            eig["s"] + eig["damp"])
        return right(left(qa, t), qg.transpose(-1, -2))

    for meta in metas:
        s_ = meta.n_stack
        blk = resolve(meta)(meta, kcfg, dev)
        eig = {"qa": basis(s_, meta.a_dim, meta.a_kind, meta.a_blocks),
               "qg": basis(s_, meta.g_dim, meta.g_kind, meta.g_blocks),
               "s": torch.rand(s_, meta.a_dim, meta.g_dim, generator=g,
                               device=dev),
               "damp": torch.full((s_, meta.a_dim, meta.g_dim), 0.05,
                                  device=dev)}
        v = torch.randn(s_, meta.a_dim, meta.g_dim, generator=g, device=dev)
        compare(f"block eigen apply gemma2 {meta.name} "
                f"({meta.a_kind}/{meta.g_kind})", blk.precondition_eigen(
                    eig, v), INV.apply_eigen(meta, eig, v), errs)
        ops.append((meta, blk, eig, v))
        a, gd = meta.a_dim, meta.g_dim
        da, dg = a // meta.a_blocks, gd // meta.g_blocks
        plans += [mm_plan(s_ * meta.a_blocks, da, gd, da),
                  mm_plan(s_ * meta.g_blocks, a, dg, dg)] * 2
        flops += 4.0 * s_ * a * gd * (da + dg) + s_ * a * gd
        nbytes += 4.0 * s_ * (3 * a * da + 3 * gd * dg + 3 * a * gd)
    rr["cases"]["gemma2-2b blocks"] = dict(
        unit=f"the MLP's stacked layers of the {g2_layers}-layer gemma2-2b "
             "eigen run, Q_A[(Q_Aᵀ V Q_G)/(s + damp)]Q_Gᵀ through "
             "BlockDiagKronecker (four matmul launches, a block side's "
             "blocks in their batch): "
             + ", ".join(f"{m.name} ({m.n_stack}, {m.a_dim}, {m.g_dim}) "
                         f"{m.a_kind}/{m.g_kind}" for m, *_ in ops),
        plans=plans,
        **timings(lambda: [b.precondition_eigen(e, v) for _, b, e, v in ops],
                  lambda: [INV.apply_eigen(m, e, v) for m, _, e, v in ops],
                  lambda: [library(m, e, v) for m, _, e, v in ops], reps=3),
        library_calls="bmm / batched matmul, div",
        bound=bound_ms(flops, nbytes))
    rr["max_abs_err"] = max(rr["max_abs_err"], *errs)
    rows["matmul"]["max_abs_err"] = max(rows["matmul"]["max_abs_err"],
                                        *errs)
    del ops
    torch.cuda.empty_cache()

    # 5a: the batched chain at smollm-135m's stacked layers
    def spd(s_, d):
        f = torch.randn(s_, d, 512, generator=g, device=dev)
        return torch.bmm(f, f.transpose(1, 2)) / 512 + 0.1 * torch.eye(
            d, device=dev)

    al, mu = torch.tensor(-0.05, device=dev), torch.tensor(0.9, device=dev)
    cops = [(spd(S, a), torch.randn(S, a, gd, generator=g, device=dev),
             spd(S, gd), torch.randn(S, a, gd, generator=g, device=dev))
            for a, gd in smollm]
    errs, errs_ax = [], []

    def rel_sq(name, got, want):
        rel = abs(got.item() - want.item()) / want.item()
        print(f"  {name:48s} rel|err| {rel:.3e}  "
              f"{'ok' if rel <= TOL else 'FAIL'}")
        if not rel <= TOL:
            raise AssertionError(f"{name}: ΣD² {got.item()} vs {want.item()}")

    for (a, gd), (ai, v, gi, mom) in zip(smollm, cops):
        d, sq = precond_momentum(ai, v, gi, mom, alpha=al, mu=mu)
        d_ref, sq_ref = precond_momentum_ref(ai, v, gi, mom, alpha=al, mu=mu)
        compare(f"precond_momentum smollm ({S},{a},{gd})", d, d_ref, errs)
        rel_sq(f"precond_momentum smollm ({S},{a},{gd}) ΣD²", sq, sq_ref)
        t = torch.bmm(v, gi)
        d, sq = axpy_momentum(ai, t, mom, al, mu)
        d_ref, sq_ref = axpy_momentum_ref(ai, t, mom, al, mu)
        compare(f"axpy_momentum smollm ({S},{a},{gd})", d, d_ref, errs_ax)
        rel_sq(f"axpy_momentum smollm ({S},{a},{gd}) ΣD²", sq, sq_ref)
    aops = [(ai, torch.bmm(v, gi), mom) for ai, v, gi, mom in cops]

    def pm_library():
        for ai, v, gi, mom in cops:
            d = torch.baddbmm(mom, ai, torch.bmm(v, gi), beta=0.9,
                              alpha=-0.05)
            torch.sum(d * d)

    def ax_library():
        for ai, t, mom in aops:
            d = torch.baddbmm(mom, ai, t, beta=0.9, alpha=-0.05)
            torch.sum(d * d)

    unit = ("smollm-135m's 7 stacked layers, one batched call each: "
            + ", ".join(f"({S}, {a}, {gd})" for a, gd in smollm))
    pm = rows["precond_momentum"]
    pm.setdefault("cases", {})["smollm-135m"] = dict(
        unit=unit, plans=[p for a, gd in smollm for p in (
            mm_plan(S, a, gd, gd), f"axpy batch {S} " + ax_plan(a, gd, a))],
        **timings(lambda: [precond_momentum(ai, v, gi, mom, alpha=al, mu=mu)
                           for ai, v, gi, mom in cops],
                  lambda: [precond_momentum_ref(ai, v, gi, mom, alpha=al,
                                                mu=mu)
                           for ai, v, gi, mom in cops], pm_library, reps=5),
        library_calls="bmm, baddbmm, sum(d*d)",
        bound=bound_ms(sum(2.0 * S * a * gd * (a + gd) + 4.0 * S * a * gd
                           for a, gd in smollm),
                       4.0 * S * sum(a * a + gd * gd + 3 * a * gd
                                     for a, gd in smollm)))
    pm["max_abs_err"] = max(pm["max_abs_err"], *errs)
    ax = rows["axpy_momentum"]
    ax.setdefault("cases", {})["smollm-135m"] = dict(
        unit=unit + " (the second half)",
        plans=[f"batch {S} " + ax_plan(a, gd, a) for a, gd in smollm],
        **timings(lambda: [axpy_momentum(ai, t, mom, al, mu)
                           for ai, t, mom in aops],
                  lambda: [axpy_momentum_ref(ai, t, mom, al, mu)
                           for ai, t, mom in aops], ax_library, reps=5),
        library_calls="baddbmm, sum(d*d)",
        bound=bound_ms(sum(2.0 * S * a * a * gd + 4.0 * S * a * gd
                           for a, gd in smollm),
                       4.0 * S * sum(a * a + 3 * a * gd
                                     for a, gd in smollm)))
    ax["max_abs_err"] = max(ax["max_abs_err"], *errs_ax)
    del cops, aops
    torch.cuda.empty_cache()
    for label, r in [("rotate_rescale smollm-135m",
                      rr["cases"]["smollm-135m"]),
                     ("rotate_rescale whisper-small",
                      rr["cases"]["whisper-small"]),
                     ("block eigen apply gemma2-2b",
                      rr["cases"]["gemma2-2b blocks"]),
                     ("precond_momentum smollm-135m",
                      pm["cases"]["smollm-135m"]),
                     ("axpy_momentum smollm-135m",
                      ax["cases"]["smollm-135m"])]:
        print(f"  {label}: kernel {r['ms']:.4f} [{r['eager_ms']['ms']:.4f}] "
              f"ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}; {r['bound'][0] / r['ms']:.1%})")


def lm_bundle_checks(label: str, keep: dict, eigh_inverse: bool) -> dict:
    """``snapshot_bundle`` of a full-width run's last state, written by
    ``BundleWriter`` into a temporary directory and read back with
    ``load_bundle``: every array bit for bit, and the apply of the loaded
    bundle (each block rebuilt from the bundle's meta, its kernel route)
    to a fixed V held against the live engine: its own eigen apply within
    1e-5 (an eigen run), or (``eigh_inverse``: a blkdiag run, whose bundle
    is a fresh eigh of its factors) its apply of the eigh-damped inverses
    of the same factors and γ within min(5e-6·κ, 2e-3)."""
    import shutil
    import tempfile
    from repro_torch.core.blocks import resolve
    from repro_torch.curvature import BundleWriter, load_bundle
    from repro_torch.curvature import snapshot_bundle
    engine, state = keep["opt"].engine, keep["res"]["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = snapshot_bundle(engine, state)
    torch.cuda.synchronize()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(ROOT / "build", exist_ok=True)
    d = tempfile.mkdtemp(prefix="bundle_", dir=ROOT / "build")
    try:
        writer = BundleWriter()
        writer.write_async(os.path.join(d, "b"), bundle)
        writer.wait()
        t0 = time.perf_counter()
        back = load_bundle(os.path.join(d, "b"), device="cuda")
        read_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "b", "arrays.npz"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_arrays = 0
    for name, e in bundle.eigen.items():
        for k, v in e.items():
            if (v is None) != (back.eigen[name][k] is None) or (
                    v is not None and not torch.equal(back.eigen[name][k],
                                                      v)):
                raise AssertionError(f"{label}: bundle {name} {k} not read "
                                     "back bit for bit")
            n_arrays += v is not None
    g = torch.Generator(device="cuda").manual_seed(12)
    errs = {}
    for name, blk in engine.blocks.items():
        m = back.metas[name]
        lead = (m.n_stack,) if m.n_stack else ()
        v = torch.randn(*lead, m.a_dim, m.g_dim, generator=g, device="cuda")
        got = resolve(m)(m, engine.cfg, "cuda").precondition_eigen(
            back.eigen[name], v)
        sd = back.eigen[name]["s"] + back.eigen[name]["damp"]
        kappa = (sd.max() / sd.min()).item()
        if eigh_inverse:
            want = blk.precondition(blk.damped_inverse(
                state.factors[name], state.gamma, method="eigh"), v)
            tol = min(5e-6 * kappa, 2e-3)
        else:
            want = blk.precondition_eigen(state.inv[name], v)
            tol = 1e-5
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        errs[name] = {"max_abs_err": err, "scale": scale, "kappa": kappa,
                      "tol": tol}
    bad = {n: e for n, e in errs.items()
           if not (math.isfinite(e["max_abs_err"])
                   and e["max_abs_err"] <= e["tol"] * e["scale"])}
    for n, e in bad.items():
        print(f"  {label} bundle apply {n}: max|err| {e['max_abs_err']:.3e}"
              f", scale {e['scale']:.3e}, kappa {e['kappa']:.3e}, tol "
              f"{e['tol']:.1e} FAIL")
    if bad:
        raise AssertionError(f"{label}: bundle apply disagrees on "
                             f"{sorted(bad)}")
    worst = max(errs.values(), key=lambda e: e["max_abs_err"] / e["scale"])
    print(f"[lm_eigen:{label}] bundle: {len(bundle.eigen)} blocks, "
          f"{n_arrays} arrays, {nbytes:,} bytes; snapshot {snapshot_ms:.1f} "
          f"ms, write {writer.write_s:.2f} s, read {read_s:.2f} s; read back "
          f"bit for bit; apply vs "
          f"{'the eigh inverses' if eigh_inverse else 'the live state'}: "
          f"worst relative {worst['max_abs_err'] / worst['scale']:.3e} "
          f"(tol {worst['tol']:.1e}, kappa {worst['kappa']:.3e})")
    return {"snapshot_ms": snapshot_ms, "write_s": writer.write_s,
            "read_s": read_s, "bytes": nbytes, "arrays": n_arrays,
            "apply": errs}


def lm_eigen_phase(dev, rows: dict, whisper_peak_bytes=None) -> dict:
    """The "lm_eigen" phase: eigen mode, the fused fixed-lr chain,
    ``fused_stats`` and the curvature bundle on the LMs.  The kernels at
    the new shapes (``lm_eigen_kernel_rows``); reduced smollm-135m,
    gemma2-2b at ``max_factor_dim`` 64 and whisper-small 4 steps on the
    card and on the CPU on each of ``LE_PATHS``; full width, through
    ``launch/train.py`` with exact launches and the peak beside the
    path's reckoning: smollm-135m in eigen mode 25 steps (the γ sweep at
    20) and on the fused chain 25 steps, whisper-small in eigen mode with
    ``fused_stats`` 6 steps (its reckoning: ``whisper_peak_bytes``, the
    peak of the script's blkdiag whisper run, or ``W_BLKDIAG_PEAK_MIB``,
    plus s and damp: the activations no formula here counts), gemma2-2b
    in eigen mode at ``gemma2_eigen_layers`` 6 steps (cut before its
    sweep); then the bundles of whisper's live eigen state and of the
    smollm chain's blkdiag state.  Alone: ``python3 -c 'import chip_smoke
    as c, torch; c.lm_eigen_phase(torch.device("cuda"),
    c.kernel_rows_stub())'``."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    g2_layers = gemma2_eigen_layers(free_gib)
    print(f"[lm_eigen] gemma2-2b eigen cut: {g2_layers} layers (the deepest "
          f"whose eigen reckoning leaves {LE_MARGIN:.0%} of {free_gib:.1f} "
          "GiB free)")
    lm_eigen_kernel_rows(dev, rows, g2_layers)
    out = {"agree": {f"{arch} {mfd} {path}": agree_lm(arch, mfd=mfd, **kw)
                     for arch, mfd in (("smollm-135m", 8192),
                                       ("gemma2-2b", 64),
                                       ("whisper-small", 8192))
                     for path, kw in LE_PATHS.items()},
           "gemma2_layers": g2_layers}
    smollm_chain = {}
    out["smollm-135m_eigen"] = decoder_main(
        "smollm-135m", LE_SMOLLM_STEPS, kfac_kw=LE_PATHS["eigen"],
        label="smollm-135m eigen")
    out["smollm-135m_chain"] = decoder_main(
        "smollm-135m", LE_SMOLLM_STEPS, falling=False,
        kfac_kw=dict(use_rescale=False), label="smollm-135m chain",
        keep=smollm_chain)
    out["bundle_smollm-135m_blkdiag"] = lm_bundle_checks(
        "smollm-135m chain", smollm_chain, eigh_inverse=True)
    smollm_chain.clear()
    torch.cuda.empty_cache()
    whisper = {}
    # whisper's peak is mostly its activations' (no remat), which
    # decoder_memory does not count: its reckoning starts from the blkdiag
    # run's whole peak
    base = (whisper_peak_bytes / 2 ** 30 if whisper_peak_bytes
            else W_BLKDIAG_PEAK_MIB / 1024)
    print(f"[lm_eigen] whisper-small's eigen reckoning: the blkdiag run's "
          f"peak {base:.2f} GiB "
          f"({'this run' if whisper_peak_bytes else 'W_BLKDIAG_PEAK_MIB'}) "
          "plus s and damp")
    out["whisper-small_eigen_fs"] = decoder_main(
        "whisper-small", LE_WHISPER_STEPS, kfac_kw=LE_PATHS["fused_stats"],
        label="whisper-small eigen fused_stats", keep=whisper,
        base_peak_gib=base)
    out["bundle_whisper-small_eigen"] = lm_bundle_checks(
        "whisper-small eigen", whisper, eigh_inverse=False)
    whisper.clear()
    torch.cuda.empty_cache()
    # the loss is held finite, not falling, as in the "gemma2" phase
    out["gemma2-2b_eigen"] = decoder_main(
        "gemma2-2b", LE_G2_STEPS, falling=False,
        cfg=get_config("gemma2-2b").replace(n_layers=g2_layers),
        kfac_kw=LE_PATHS["eigen"], label=f"gemma2-2b@{g2_layers} eigen")
    for label in ("smollm-135m_eigen", "smollm-135m_chain",
                  "whisper-small_eigen_fs", "gemma2-2b_eigen"):
        r = out[label]
        run = r["peak_mem_bytes"] - r["resident_bytes_before"]
        r["peak_vs_reckoned"] = run / 2 ** 30 / r["reckoned_peak_gib"] - 1
        if abs(r["peak_vs_reckoned"]) > 0.10:
            raise AssertionError(f"{label}: the run's peak {run:,} B is "
                                 f"{r['peak_vs_reckoned']:+.1%} off its "
                                 f"reckoning {r['reckoned_peak_gib']:.2f} GiB")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[lm_eigen] phase done in {out['phase_s']:.1f} s")
    return out


def kernel_rows_stub() -> dict:
    """The fields of phase 3's rows that ``decoder_kernel_rows``,
    ``gemma2_kernel_rows`` and ``lm_eigen_kernel_rows`` add to, for
    running the "decoders", "gemma2" or "lm_eigen" phase alone."""
    return {"factor_update": {"cases": {}, "max_abs_err": 0.0},
            "ns_step": {"cases": {}, "max_abs_err": 0.0},
            "precondition": {"max_abs_err": 0.0},
            "matmul": {"max_abs_err": 0.0},
            "rotate_rescale": {"max_abs_err": 0.0},
            "precond_momentum": {"max_abs_err": 0.0},
            "axpy_momentum": {"max_abs_err": 0.0}}


def main() -> None:
    t_start = time.perf_counter()
    # ---- 1. device ---------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script runs the port on the card and has no CPU fallback")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi()
    print(f"[device] {kind} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; tf32 off")

    from repro_torch.configs.autoencoder import CONFIG, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticAutoencoderData
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.gemm_plan import dense_plan as mr_plan
    from repro_torch.kernels.gemm_plan import sm_count
    from repro_torch.kernels.matmul import matmul, matmul_ref, operands
    from repro_torch.kernels.ns_step import (ns_inverse, ns_inverse_ref,
                                             ns_step, ns_step_ref)
    from repro_torch.kernels.precond import precondition, precondition_ref
    from repro_torch.kernels.rotate_rescale import (matmul_rescale,
                                                    matmul_rescale_ref,
                                                    rotate_rescale,
                                                    rotate_rescale_ref)
    from repro_torch.kernels.update_chain import (axpy_momentum,
                                                  axpy_momentum_ref,
                                                  precond_momentum,
                                                  precond_momentum_ref)
    from repro_torch.models.mlp import MLP, autoencoder_dims
    from repro_torch.training.trainer import Trainer

    # ---- 2. build ----------------------------------------------------
    lib = _build.load()
    print(f"[build] {lib.path.relative_to(ROOT)} in {lib.build_seconds:.1f} s"
          f"{' (loaded an existing build)' if not lib.log else ''}")
    for line in lib.log.splitlines():
        if (line.startswith("==") or "registers" in line or "spill" in line
                or "entry function" in line):
            print(f"  {line.strip()}")

    # ---- 3. kernels at the main path's shapes ------------------------
    dims = autoencoder_dims(CONFIG)
    layers = [(dims[i] + 1, dims[i + 1]) for i in range(len(dims) - 1)]
    sides = [d for ag in layers for d in ag]            # 16 factor sides
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)

    def spd(d, n=N_ROWS, damp=0.1):
        x = torch.tanh(randn(n, d))
        return x.T @ x / n + damp * torch.eye(d, device=dev)

    rows = {}
    print(f"[kernels] tolerance max|err| <= {TOL:g} * scale: max|ref|, or "
          f"max|alpha * XᵀX| for factor_update")

    rows["factor_update"] = factor_update_row(dev, randn, spd, sides,
                                              lib.log)

    # patch_factor: ragged cases and whisper-small's two conv stems
    rows["patch_factor"] = patch_kernel_row(dev, g)

    # precondition: every (a, g) pair of the 8 layers
    errs = []
    ops = [(spd(a, 512), randn(a, gd), spd(gd, 512)) for a, gd in layers]
    for (a, gd), (ai, v, gi) in zip(layers, ops):
        compare(f"precondition a={a} g={gd}", precondition(ai, v, gi),
                precondition_ref(ai, v, gi), errs)
    pc = lambda f: [f(*o) for o in ops]
    # matmul's plans, (a, g) @ (g, g) then (a, a) @ (a, g), of each layer
    pc_plans = [mm_plan(1, a, gd, k_) for a, gd in layers for k_ in (gd, a)]
    rows["precondition"] = dict(
        plans=pc_plans,
        source="src/repro_torch/kernels/precond.py",
        replaces="src/repro/kernels/precond.py:12",
        unit="all 8 layers of one step (two matmul launches each)",
        max_abs_err=max(errs),
        **timings(lambda: pc(precondition), lambda: pc(precondition_ref),
                  lambda: [torch.linalg.multi_dot(list(o)) for o in ops]),
        bound=bound_ms(sum(2.0 * a * gd * (a + gd) for a, gd in layers),
                       4.0 * sum(a * a + 2 * a * gd + gd * gd
                                 for a, gd in layers)))
    del ops

    # matmul: the products above go through it; direct checks at the
    # sweep's batched shape and with alpha/beta as device scalars
    errs = []
    m3 = torch.stack([spd(1001, 512, dmp) for dmp in (0.1, 0.2, 0.05)])
    x3 = torch.stack([torch.eye(1001, device=dev) / 3.0] * 3) + 1e-3 * randn(
        3, 1001, 1001)
    compare("matmul (3,1001,1001)@(3,1001,1001)", matmul(m3, x3),
            matmul_ref(m3, x3), errs)
    compare("matmul epilogue -X@Z + 2X, batched x3",
            matmul(x3, m3, x3, alpha=-1.0, beta=2.0),
            matmul_ref(x3, m3, x3, alpha=-1.0, beta=2.0), errs)
    a31, b31, c31 = randn(31, 31), randn(31, 30), randn(31, 30)
    al, be = torch.tensor(0.3, device=dev), torch.tensor(-1.5, device=dev)
    compare("matmul (31,31)@(31,30), alpha/beta on device",
            matmul(a31, b31, c31, alpha=al, beta=be),
            matmul_ref(a31, b31, c31, alpha=al, beta=be), errs)
    v1000 = randn(1001, 1000)
    compare("matmul (1001,1001)@(1001,1000)", matmul(m3[0], v1000),
            matmul_ref(m3[0], v1000), errs)
    # from this process's build log (empty when an existing build loaded)
    resources = ptxas_resources(lib.log, "matmul_kernel")
    for args, regs, st, ld in resources:
        print(f"  matmul_kernel<{args}>: {regs} registers, spill stores "
              f"{st} B, loads {ld} B")
    tiles = {r[0].split("E")[0] for r in resources}
    if ((lib.log and not tiles >= {"ILi128", "ILi64"})
            or any(st or ld or regs > 128 for _, regs, st, ld in resources)):
        raise AssertionError(f"matmul: a tile missing, over 128 registers "
                             f"or spilling: {resources}")
    rows["matmul"] = dict(
        source="src/repro_torch/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul.py:42",
        unit="one batched launch (3,1001,1001)@(3,1001,1001), the gamma "
             "sweep's Z = M X for the widest factor",
        plans=[mm_plan(3, 1001, 1001, 1001)], registers=resources,
        max_abs_err=max(errs),
        **timings(lambda: matmul(m3, x3), lambda: matmul_ref(m3, x3),
                  lambda: torch.bmm(m3, x3)),
        bound=bound_ms(2.0 * 3 * 1001 ** 3, 4.0 * 3 * 3 * 1001 ** 2))

    # ns_step / ns_inverse: d in {1001, 785, 31}, and batched x3
    errs = []
    for d in (1001, 785, 31):
        m = spd(d)
        x0 = torch.eye(d, device=dev) / m.abs().sum(-1).max()
        compare(f"ns_step d={d}", ns_step(m, x0), ns_step_ref(m, x0), errs)
        compare(f"ns_inverse d={d} (12 iterations)", ns_inverse(m, 12),
                ns_inverse_ref(m, 12), errs)
    compare("ns_inverse (3,1001,1001) (12 iterations)", ns_inverse(m3, 12),
            ns_inverse_ref(m3, 12), errs)
    del m3, x3
    ms_ = [spd(d) for d in sides]
    x0s = [torch.eye(d, device=dev) / m.abs().sum(-1).max()
           for d, m in zip(sides, ms_)]

    def refresh(step_fn):
        for m, x in zip(ms_, x0s):
            for _ in range(12):
                x = step_fn(m, x)

    cube = sum(d ** 3 for d in sides)
    rows["ns_step"] = dict(
        source="src/repro_torch/kernels/ns_step.py",
        replaces="src/repro/kernels/ns_step.py:17",
        unit="one full Newton-Schulz refresh: 16 factors x 12 steps",
        plans=[mm_plan(1, d, d, d) for d in sides],
        **timings(lambda: refresh(ns_step), lambda: refresh(ns_step_ref),
                  lambda: refresh(lambda m, x: torch.addmm(
                      x, x, torch.mm(m, x), beta=2.0, alpha=-1.0)), reps=3),
        bound=bound_ms(4.0 * 12 * cube, 4.0 * sum(2 * d * d for d in sides)))
    del ms_, x0s
    # whisper-small's stacked Newton-Schulz step: the 12 layers' (768, 768)
    # and (3072, 3072) factors, one ns_step each (two batched launches); a
    # second generator leaves randn's draws as they were
    rows["ns_step"]["cases"] = {}
    gw = torch.Generator(device=dev).manual_seed(3)
    for d in (768, 3072):
        f = torch.randn(12, d, 512, generator=gw, device=dev)
        m = (torch.bmm(f, f.transpose(1, 2)) / 512
             + 0.1 * torch.eye(d, device=dev))
        del f
        x0 = torch.eye(d, device=dev) / m.abs().sum(-1).amax(-1)[:, None,
                                                                   None]
        x = ns_step_ref(m, x0)
        del x0
        compare(f"ns_step whisper-small stacked (12,{d},{d})", ns_step(m, x),
                ns_step_ref(m, x), errs)
        rows["ns_step"]["cases"][f"whisper-small {d}"] = dict(
            unit=f"one stacked ns_step, M and X (12, {d}, {d})",
            plans=[mm_plan(12, d, d, d)],
            **timings(lambda: ns_step(m, x), lambda: ns_step_ref(m, x),
                      lambda: torch.baddbmm(x, x, torch.bmm(m, x), beta=2,
                                            alpha=-1)),
            bound=bound_ms(4.0 * 12 * d ** 3, 4.0 * 12 * 3 * d * d))
        del m, x
    rows["ns_step"]["max_abs_err"] = max(errs)

    # rotate_rescale / matmul_rescale: every (a, g) pair of the 8 layers,
    # orthonormal bases from eigh on the card, lam as a device scalar
    errs, errs_mr = [], []
    lam = torch.tensor(1e-12, device=dev)
    eops = []
    for a, gd in layers:
        qa = torch.linalg.eigh(spd(a, 512))[1]
        qg = torch.linalg.eigh(spd(gd, 512))[1]
        eops.append((qa, randn(a, gd), qg, torch.rand(
            a, gd, generator=g, device=dev) + 0.05))
    for (a, gd), (qa, v, qg, sd) in zip(layers, eops):
        compare(f"rotate_rescale a={a} g={gd}",
                rotate_rescale(qa, v, qg, sd, lam),
                rotate_rescale_ref(qa, v, qg, sd, lam), errs)
        t = qa.T @ v
        compare(f"matmul_rescale ({a},{gd})@({gd},{gd})",
                matmul_rescale(t, qg, sd, lam),
                matmul_rescale_ref(t, qg, sd, lam), errs_mr)
    qa, v, qg, sd = eops[0]
    t3 = torch.stack([qa.T @ v] * 3) + 1e-3 * randn(3, *v.shape)
    s3 = torch.stack([sd, 2 * sd, sd + 1.0])
    compare(f"matmul_rescale batched x3 {tuple(t3.shape)}",
            matmul_rescale(t3, qg, s3, lam),
            matmul_rescale_ref(t3, qg, s3, lam), errs_mr)
    # the main loop's edges: K = N = 30 and 250 (4-byte copies of B), a B
    # one float off a 16-byte boundary (4-byte copies at N = 1000), and the
    # split K of (251, 500) @ (500, 500); each case's plan is printed
    plans = set()
    ge = torch.Generator(device=dev).manual_seed(2)  # g's draws unchanged
    for m_, k_, off in [(251, 30, 0), (501, 250, 0), (785, 1000, 1),
                        (251, 500, 0)]:
        t = torch.randn(m_, k_, generator=ge, device=dev)
        q = torch.randn(k_ * k_ + off, generator=ge,
                        device=dev)[off:].view(k_, k_)
        sd_ = torch.rand(m_, k_, generator=ge, device=dev) + 0.05
        vec = gemm_plan.dense_vec16(operands("matmul_rescale", t, q, sd_))
        plan = mr_plan(1, m_, k_, k_, sm_count(0))
        plans.add((plan.splits > 1, vec))
        compare(f"matmul_rescale ({m_},{k_}) b+{off} splits {plan.splits} "
                f"vec16 {int(vec)}",
                matmul_rescale(t, q, sd_, lam),
                matmul_rescale_ref(t, q, sd_, lam), errs_mr)
    if not {(True, True), (False, False)} <= plans:
        raise AssertionError(f"matmul_rescale edge cases missed a plan: "
                             f"{plans}")
    mids = [(qa.T @ v, qg, sd) for qa, v, qg, sd in eops]
    rr = lambda f: [f(*o, lam) for o in eops]
    rows["rotate_rescale"] = dict(
        # matmul's three launches a layer: Q_Aᵀ V, Q_A ·, · Q_Gᵀ
        plans=[mm_plan(1, a, gd, k_) for a, gd in layers
               for k_ in (a, a, gd)],
        source="src/repro_torch/kernels/rotate_rescale.py",
        replaces="src/repro/kernels/rotate_rescale.py:86",
        unit="all 8 layers of one step (four launches each)",
        max_abs_err=max(errs),
        **timings(lambda: rr(rotate_rescale), lambda: rr(rotate_rescale_ref),
                  lambda: [torch.mm(torch.mm(qa, torch.mm(torch.mm(
                      qa.T, v), qg).div_(sd)), qg.T)
                      for qa, v, qg, sd in eops]),
        library_calls="mm, mm, div, mm, mm",
        bound=bound_ms(sum(4.0 * a * gd * (a + gd) + a * gd
                           for a, gd in layers),
                       4.0 * sum(a * a + gd * gd + 3 * a * gd
                                 for a, gd in layers)))
    mr = lambda f: [f(t, qg, sd, lam) for t, qg, sd in mids]
    rows["matmul_rescale"] = dict(
        source="src/repro_torch/csrc/rotate_rescale.cu",
        replaces="src/repro/kernels/rotate_rescale.py:49",
        unit="the 8 middle products (T Q_G) / (S + lam) of one step",
        max_abs_err=max(errs_mr),
        **timings(lambda: mr(matmul_rescale), lambda: mr(matmul_rescale_ref),
                  lambda: [torch.mm(t, qg).div_(sd) for t, qg, sd in mids]),
        library_calls="mm, div",
        bound=bound_ms(sum(2.0 * a * gd * gd + a * gd for a, gd in layers),
                       4.0 * sum(3 * a * gd + gd * gd for a, gd in layers)))

    # precond_momentum / axpy_momentum: the 8 layers, alpha/mu on the
    # device; D normwise, ΣD² to relative 1e-4.  axpy_momentum_kernel's
    # 4 instantiations (VEC x A_ROWS) from the build log
    resources = ptxas_resources(lib.log, "axpy_momentum_kernel")
    for args, regs, st, ld in resources:
        print(f"  update_chain {args}: {regs} registers, spill stores {st} "
              f"B, loads {ld} B")
    if ((lib.log and len(resources) != 4)
            or any(st or ld or regs > 128 for _, regs, st, ld in resources)):
        raise AssertionError(f"axpy_momentum: an instantiation missing, "
                             f"over 128 registers or spilling: {resources}")
    errs, errs_ax = [], []
    al, mu = torch.tensor(-0.02, device=dev), torch.tensor(0.9, device=dev)
    cops = [(spd(a, 512), randn(a, gd), spd(gd, 512), randn(a, gd))
            for a, gd in layers]

    def compare_sq(name, got, want):
        rel = abs(got.item() - want.item()) / want.item()
        print(f"  {name:48s} rel|err| {rel:.3e}  "
              f"{'ok' if rel <= TOL else 'FAIL'}")
        if not rel <= TOL:
            raise AssertionError(f"{name}: ΣD² {got.item()} vs {want.item()}")

    for (a, gd), (ai, v, gi, mom) in zip(layers, cops):
        d, sq = precond_momentum(ai, v, gi, mom, alpha=al, mu=mu)
        d_ref, sq_ref = precond_momentum_ref(ai, v, gi, mom, alpha=al, mu=mu)
        compare(f"precond_momentum a={a} g={gd}", d, d_ref, errs)
        compare_sq(f"precond_momentum a={a} g={gd} ΣD²", sq, sq_ref)
        t = v @ gi
        d, sq = axpy_momentum(ai, t, mom, al, mu)
        d_ref, sq_ref = axpy_momentum_ref(ai, t, mom, al, mu)
        compare(f"axpy_momentum a={a} g={gd}", d, d_ref, errs_ax)
        compare_sq(f"axpy_momentum a={a} g={gd} ΣD²", sq, sq_ref)
    pm = lambda f: [f(ai, v, gi, mom, alpha=al, mu=mu)
                    for ai, v, gi, mom in cops]

    def pm_library():
        for ai, v, gi, mom in cops:
            d = torch.addmm(mom, ai, torch.mm(v, gi), beta=0.9, alpha=-0.02)
            torch.sum(d * d)

    rows["precond_momentum"] = dict(
        # matmul's T = V G^-1, then axpy_momentum's, of each layer
        plans=[p for a, gd in layers
               for p in (mm_plan(1, a, gd, gd), "axpy " + ax_plan(a, gd, a))],
        source="src/repro_torch/kernels/update_chain.py",
        replaces="src/repro/kernels/update_chain.py:99",
        unit="all 8 layers of one step (two launches each)",
        max_abs_err=max(errs),
        **timings(lambda: pm(precond_momentum),
                  lambda: pm(precond_momentum_ref), pm_library),
        library_calls="mm, addmm, sum(d*d)",
        bound=bound_ms(sum(2.0 * a * gd * (a + gd) + 4.0 * a * gd
                           for a, gd in layers),
                       4.0 * sum(a * a + gd * gd + 3 * a * gd
                                 for a, gd in layers)))
    aops = [(ai, v @ gi, mom) for ai, v, gi, mom in cops]
    ax = lambda f: [f(ai, t, mom, al, mu) for ai, t, mom in aops]

    def ax_library():
        for ai, t, mom in aops:
            d = torch.addmm(mom, ai, t, beta=0.9, alpha=-0.02)
            torch.sum(d * d)

    rows["axpy_momentum"] = dict(
        plans=[ax_plan(a, gd, a) for a, gd in layers], registers=resources,
        # the pipelined main loop's 64 tile (gemm_pipeline.cuh), K whole,
        # the ΣD² epilogue summed in a fixed order
        source="src/repro_torch/csrc/update_chain.cu",
        replaces="src/repro/kernels/update_chain.py:53",
        unit="the 8 second halves alpha (A^-1 T) + mu M, ΣD² of one step "
             "(gemm_pipeline.cuh's 64 tile, K whole)",
        max_abs_err=max(errs_ax),
        **timings(lambda: ax(axpy_momentum), lambda: ax(axpy_momentum_ref),
                  ax_library),
        library_calls="addmm, sum(d*d)",
        bound=bound_ms(sum(2.0 * a * a * gd + 4.0 * a * gd
                           for a, gd in layers),
                       4.0 * sum(a * a + 3 * a * gd for a, gd in layers)))
    del eops, mids, cops, aops

    # torch.linalg.eigh of the 16 factors: the eigen path's refresh
    # (the reference calls jnp.linalg.eigh; no kernel replaces it)
    facs = [spd(d) for d in sides]
    eigh_ms = eager_ms(lambda: [torch.linalg.eigh(f) for f in facs], reps=3)
    del facs
    print(f"  torch.linalg.eigh of the 16 factor sides (one eigen refresh): "
          f"{eigh_ms:.3f} ms eager")

    # flash_decode / flash_decode_paged at the serve path's shapes, and
    # flash_attention at the prefill's
    rows.update(decode_kernel_rows(dev, g))
    rows["flash_attention"] = attention_kernel_row(dev, g, lib.log)

    print("  device time (CUDA graph replay); eager (back-to-back calls) in "
          "brackets")
    for name, r in rows.items():
        e = r["eager_ms"]
        print(f"  {name:14s} {r['unit']}: kernel {r['ms']:.4f} "
              f"[{e['ms']:.4f}] ms, plain {r['plain_ms']:.4f} "
              f"[{e['plain_ms']:.4f}] ms, library {fmt_ms(r['library_ms'])} "
              f"[{fmt_ms(e['library_ms'])}] ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})")
    wu = rows["factor_update"]["cases"]["whisper-small"]
    print(f"  factor_update {wu['unit']}: kernel {wu['ms']:.4f} "
          f"[{wu['eager_ms']['ms']:.4f}] ms, plain {wu['plain_ms']:.4f} ms, "
          f"library {wu['library_ms']:.4f} ms (baddbmm), bound "
          f"{wu['bound'][0]:.4f} ms ({wu['bound'][1]})")
    for label, r in rows["ns_step"]["cases"].items():
        print(f"  ns_step {r['unit']}: kernel {r['ms']:.4f} "
              f"[{r['eager_ms']['ms']:.4f}] ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms (bmm + baddbmm), bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    for name in ("matmul", "precondition", "ns_step", "rotate_rescale"):
        print(f"  {name} matmul plans (batch x m x n x k: tile/splits): "
              f"{rows[name]['plans']}")
    print(f"  axpy_momentum launches (m x n x k: tile/splits, copies): "
          f"{rows['axpy_momentum']['plans']}")
    print(f"  precond_momentum plans (matmul, then axpy): "
          f"{rows['precond_momentum']['plans']}")
    for label, r in rows["ns_step"]["cases"].items():
        print(f"  ns_step {label} matmul plans: {r['plans']}")
    print(f"  patch_factor bound of the full (d, d) product: "
          f"{rows['patch_factor']['full_product_bound_ms']:.4f} ms")
    for name, r in [(name, rows[name]) for name in (
            "matmul", "precondition", "ns_step", "rotate_rescale",
            "matmul_rescale", "axpy_momentum", "precond_momentum",
            "patch_factor", "factor_update")] + [
            ("factor_update whisper-small", wu)] + [
            (f"ns_step {label}", r)
            for label, r in rows["ns_step"]["cases"].items()]:
        print(f"  {name}: {r['bound'][0] / r['ms']:.1%} of its bound, "
              f"{r['bound'][0] * FP32_FLOPS / 1e12 / r['ms']:.2f} TFLOP/s "
              f"(the bound's operations over the device time)")

    print(f"[time] kernels phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- 4. agreement with the plain path on a small input -----------
    paths = ae_paths()
    small = autoencoder_dims(reduced())
    for label, cfg in agree_paths().items():
        agree_ae(label, cfg, "bernoulli")
    from repro_torch import optimizers
    for label, lr in (("sgd_momentum", 0.1), ("adam", 1e-2)):
        hist = {}
        for where in ("cuda", "cpu"):
            mlp = MLP(small, device=where)
            params = mlp.init_params(torch.Generator().manual_seed(0))
            data = SyntheticAutoencoderData(small[0], 8, 256, seed=7,
                                            device=where)
            tr = Trainer(mlp, optimizers.get(label, mlp, lr=lr),
                         TrainConfig(seed=0, log_every=10 ** 9),
                         device=where)
            hist[where] = [h["loss"] for h in tr.fit(
                params, data, steps=6, log=lambda *_: None)["history"]]
        print(f"[agree:{label}] reduced autoencoder losses cuda "
              f"{hist['cuda']}")
        print(f"        plain versions on the cpu    {hist['cpu']}")
        for a, b in zip(hist["cuda"], hist["cpu"]):
            if not abs(a - b) <= 1e-3 * abs(b):
                raise AssertionError(f"{label}: cuda path {a} vs cpu path "
                                     f"{b}")
    serve_agree = {arch: agree_serving(arch)
                   for arch in ("smollm-135m", "llama3.2-1b", "gemma2-2b")}
    whisper_agree = agree_lm("whisper-small")

    print(f"[time] agree phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- 5. the main paths -------------------------------------------
    steps = AE_STEPS
    mlp, params, data = ae_model()
    main_out, launches_by_path, profiles = {}, {}, {}
    for label in paths:
        main_out[label] = autoencoder_main(label, steps, mlp, params, data)
        launches_by_path[label] = main_out[label]["launches"]

    print(f"[time] main phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- modes: τ1, stats_period, staggered refresh, Gaussian loss ----
    modes_kernel_rows(dev, rows, sides)
    for label, (cfg, loss) in modes_paths().items():
        agree_ae(label, cfg, loss)
    # blkdiag again first: the modes' baseline in the same stretch of the
    # process (the paths after tridiag's cuSOLVER run read slower)
    for label in ("blkdiag", *modes_paths()):
        key = f"modes_{label}"
        main_out[key] = autoencoder_main(label, steps, mlp, params, data)
        launches_by_path[key] = main_out[key]["launches"]
    main_out["modes_summary"] = modes_summary(main_out)
    print(f"[time] modes phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- race: first-order baselines against K-FAC at full width ------
    t_race = time.perf_counter()
    reused = {f"kfac_{label}": main_out[label]
              for label in ("blkdiag", "tridiag")}
    race_out = race_main(mlp, params, data, reused, steps)
    race_out["phase_s"] = time.perf_counter() - t_race
    for row, r in race_out["rows"].items():
        if row not in reused:              # phase 5's runs are counted there
            launches_by_path[f"race_{row}"] = r["launches"]
    print(f"[time] race phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- ckpt: checkpoints, resume, preemption, curvature bundles ----
    for label in paths:
        key = f"ckpt_{label}"
        main_out[key] = ckpt_ae(label, mlp, params, data,
                                main_out[label]["losses"])
        launches_by_path[f"{key}_to{CKPT_AT}"] = main_out[key][
            "launches_first"]
        launches_by_path[key] = main_out[key]["launches"]
    main_out["ckpt_preempt"] = ckpt_preempt(mlp, params, data)
    print(f"[time] ckpt phase (autoencoder) done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- conv: KFC convolutions and backward-pass fused statistics ----
    t_conv = time.perf_counter()
    conv_kernel_rows(dev, rows)
    conv_out = {"agree": {label: agree_conv(label, cfg)
                          for label, cfg in conv_paths().items()}}
    for label, cfg in conv_paths().items():
        conv_out[label] = conv_main(label, cfg, steps)
        launches_by_path[f"conv_{label}"] = conv_out[label]["launches"]
    for label in ("blkdiag", "eigen"):
        key = f"ae_fs_{label}"
        first = fused_first_pass(label, mlp, params, data)
        main_out[key] = autoencoder_main(
            key, steps, mlp, params, data,
            cfg=dataclasses.replace(paths[label], fused_stats=True))
        main_out[key]["first_pass_max_rel"] = first
        main_out[key]["max_rel_vs_two_pass"] = fused_trajectory(
            label, main_out[key]["losses"], main_out[label]["losses"])
        launches_by_path[key] = main_out[key]["launches"]
    conv_out["phase_s"] = time.perf_counter() - t_conv
    print(f"[time] conv phase done at "
          f"{time.perf_counter() - t_start:.1f} s ({conv_out['phase_s']:.1f}"
          f" s)")
    # ---- 6. the serve path -------------------------------------------
    # full-width llama3.2-1b, the port's own weights from seed 0: 32
    # greedy requests, prompts of 64..1024 tokens (all lengths distinct, so
    # every prefill is a group of one), 64 new tokens each, through 16
    # slots.  Every run keeps 16 slots: a row's decode arithmetic then has
    # the same shapes in every run, so its tokens must be equal bit for bit.
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    t_serve = time.perf_counter()
    serve_out = {}
    cfg = get_config("llama3.2-1b")
    lm = LM(cfg, device="cuda")
    lparams = lm.init_params(torch.Generator(device="cuda").manual_seed(0))
    lengths = np.random.default_rng(0).permutation(
        np.linspace(64, 1024, 32).astype(int))
    kw = dict(batch_slots=16, max_len=2048, page_size=8)
    serve_run("llama3.2-1b warmup", lm, lparams,
              serve_requests(cfg, [64, 100], 2, seed=9), **kw)
    serve_out["main"], tokens = serve_run(
        "llama3.2-1b", lm, lparams, serve_requests(cfg, lengths, 64), **kw)
    # the first 16 requests through a pool that holds their prompts and 16
    # pages more: each needs 8 more pages for its 64 tokens, so decode
    # growth must preempt
    first = serve_requests(cfg, lengths, 64)[:16]
    pages = 1 + sum(-(-len(r.prompt) // 8) for r in first) + 16
    serve_out["pressure"], tokens_p = serve_run(
        "llama3.2-1b pressure", lm, lparams, first, num_pages=pages, **kw)
    if serve_out["pressure"]["preemptions"] <= 0:
        raise AssertionError("pressure run: no preemption")
    if tokens_p != tokens[:16]:
        raise AssertionError("pressure run: tokens differ from the "
                             "unpressured run's")
    # a few steps on the gather route: the first 16 requests, 4 tokens each
    serve_out["gather"], tokens_g = serve_run(
        "llama3.2-1b gather", lm, lparams,
        serve_requests(cfg, lengths, 4)[:16], route="gather", **kw)
    if tokens_g != [t[:4] for t in tokens[:16]]:
        raise AssertionError("gather route: tokens differ from the paged "
                             "route's")
    logits = torch.randn(16, cfg.vocab_size, device="cuda")
    serve_out["logits_host_copy_ms"] = eager_ms(logits.cpu, reps=20)
    del logits
    print(f"  logits host copy (16, {cfg.vocab_size}) float32, pageable: "
          f"{serve_out['logits_host_copy_ms']:.3f} ms (CUDA events)")
    serve_out["n_params"] = lm.n_params()
    serve_out["profile"] = profile_serving(
        "serve", lm, lparams, serve_requests(cfg, lengths, 64)[:16], **kw)
    del lparams
    torch.cuda.empty_cache()

    # full-width gemma2-2b (26 layers, d 2304, hd 256, vocab 256000, local
    # layers with a window of 4096 on even pattern positions, softcaps 50
    # and 30), the port's own weights from seed 0: 16 greedy requests
    # through 16 slots of max_len 8192, 32 new tokens each.  The first two
    # prompts, 6000 and 5000 tokens, pass the window in prefill and in
    # decode; then 14 distinct lengths in 64..4096.  Then the first four
    # for 4 tokens on the gather route, in the same slots: tokens equal.
    t_gemma = time.perf_counter()
    cfg = get_config("gemma2-2b")
    lm = LM(cfg, device="cuda")
    gparams = lm.init_params(torch.Generator(device="cuda").manual_seed(0))
    glengths = [6000, 5000] + list(np.random.default_rng(1).permutation(
        np.linspace(64, 4096, 14).astype(int)))
    gkw = dict(batch_slots=16, max_len=8192, page_size=8)
    serve_run("gemma2-2b warmup", lm, gparams,
              serve_requests(cfg, [64, 100], 2, seed=9), **gkw)
    serve_out["gemma2"], gtokens = serve_run(
        "gemma2-2b", lm, gparams, serve_requests(cfg, glengths, 32), **gkw)
    serve_out["gemma2_gather"], gtokens_g = serve_run(
        "gemma2-2b gather", lm, gparams,
        serve_requests(cfg, glengths, 4)[:4], route="gather", **gkw)
    if gtokens_g != [t[:4] for t in gtokens[:4]]:
        raise AssertionError("gemma2-2b gather route: tokens differ from "
                             "the paged route's")
    serve_out["gemma2_n_params"] = lm.n_params()
    serve_out["gemma2_profile"] = profile_serving(
        "serve:gemma2-2b", lm, gparams, serve_requests(cfg, glengths, 32),
        profile_prefill=True, **gkw)
    del gparams
    torch.cuda.empty_cache()
    serve_out["gemma2_phase_s"] = time.perf_counter() - t_gemma
    serve_out["phase_s"] = time.perf_counter() - t_serve

    print(f"[time] serve phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # full-width whisper-small through the launcher (batch 8, seq 64,
    # lambda_init 10, T3 5, blkdiag ns): warmup refreshes at steps 0-2, the
    # T3 refresh at 5, lambda steps at 4 and 9
    # with --ckpt_dir: its checkpoint at step 10, then the ckpt phase's
    # relaunch resumes there (one whisper save and one restore)
    import shutil
    wdir = ckpt_dir("whisper")
    need = whisper_ckpt_bytes()
    free = shutil.disk_usage(wdir).free
    print(f"[ckpt:whisper] predicted checkpoint {need:,} bytes, "
          f"{free:,} bytes free")
    if free < 1.2 * need:
        raise AssertionError(f"whisper: {free:,} bytes free for a "
                             f"{need:,}-byte checkpoint")
    main_out["whisper"] = whisper_main(W_STEPS, wdir)
    launches_by_path["whisper"] = main_out["whisper"]["launches"]
    main_out["ckpt_whisper"] = dict(whisper_resume(wdir),
                                    **main_out["whisper"]["ckpt"],
                                    predicted_bytes=need)
    launches_by_path["ckpt_whisper"] = main_out["ckpt_whisper"]["launches"]
    shutil.rmtree(wdir)
    main_out["whisper_adam"] = lm_adam("whisper-small")
    launches_by_path["whisper_adam"] = main_out["whisper_adam"]["launches"]
    # the modes phase's whisper run, after serving as whisper's own
    main_out["modes_whisper"] = whisper_modes()
    launches_by_path["modes_whisper"] = main_out["modes_whisper"]["launches"]
    print(f"[time] whisper phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- decoders: K-FAC training of smollm-135m and llama3.2-1b ------
    dec_out = decoders_phase(dev, rows)
    for label in ("smollm-135m", "smollm-135m_adam", "llama3.2-1b"):
        launches_by_path[f"dec_{label}"] = dec_out[label]["launches"]
    print(f"[time] decoders phase done at "
          f"{time.perf_counter() - t_start:.1f} s ({dec_out['phase_s']:.1f}"
          f" s)")
    # ---- gemma2: block-diagonal factors, gemma2-2b's K-FAC training ----
    g2_out = gemma2_phase(dev, rows)
    for label in ("gemma2-2b", "gemma2-2b_adam"):
        launches_by_path[f"g2_{label}"] = g2_out[label]["launches"]
    print(f"[time] gemma2 phase done at "
          f"{time.perf_counter() - t_start:.1f} s ({g2_out['phase_s']:.1f}"
          f" s)")
    # ---- lm_eigen: EKFAC, the fused chain, fused_stats and bundles -----
    le_out = lm_eigen_phase(
        dev, rows, whisper_peak_bytes=main_out["whisper"]["peak_mem_bytes"])
    for label in ("smollm-135m_eigen", "smollm-135m_chain",
                  "whisper-small_eigen_fs", "gemma2-2b_eigen"):
        launches_by_path[f"le_{label}"] = le_out[label]["launches"]
    print(f"[time] lm_eigen phase done at "
          f"{time.perf_counter() - t_start:.1f} s ({le_out['phase_s']:.1f}"
          f" s)")
    # ---- 7. where the time goes --------------------------------------
    for label, cfg in paths.items():
        profiles[label] = profile_path(label, mlp, params, data, cfg, steps)
        main_out[label]["profile"] = profiles[label]
    main_out["whisper"]["profile"] = profile_whisper()

    print(f"[time] profile phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # ---- 8. summary --------------------------------------------------
    launches_by_path["serve"] = serve_out["main"]["launches"]
    launches_by_path["serve_gather"] = serve_out["gather"]["launches"]
    launches_by_path["serve_gemma2"] = serve_out["gemma2"]["launches"]
    launches_by_path["serve_gemma2_gather"] = serve_out["gemma2_gather"][
        "launches"]
    kernels = []
    for name in ("matmul", "factor_update", "precondition", "ns_step",
                 "matmul_rescale", "rotate_rescale", "axpy_momentum",
                 "precond_momentum", "flash_decode", "flash_decode_paged",
                 "flash_attention", "patch_factor"):
        r = rows[name]
        by_path = {label: n[name] for label, n in launches_by_path.items()}
        if not any(by_path.values()):
            raise AssertionError(f"{name} launched on no main path")
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "library_calls": r.get("library_calls"),
            "eager_ms": r["eager_ms"], "unit": r["unit"],
            "n_split": r.get("n_split"), "host_us": r.get("host_us"),
            "plans": r.get("plans"), "registers": r.get("registers"),
            "blocks_per_sm": r.get("blocks_per_sm"), "cases": r.get("cases")})
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"main": main_out, "eigh_16_factors_eager_ms": eigh_ms,
                      "whisper_agree_losses": whisper_agree}))
    print(json.dumps({"serve": serve_out, "serve_agree": serve_agree}))
    print(json.dumps({"race": race_out}))
    print(json.dumps({"conv": conv_out}))
    print(json.dumps({"decoders": dec_out}))
    print(json.dumps({"gemma2": g2_out}))
    print(json.dumps({"lm_eigen": le_out}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
