#!/usr/bin/env python3
"""Device and eager times of the launch plans that ``kernels/gemm_plan.py``
weighs for the pipelined fp32 GEMM (``csrc/gemm_pipeline.cuh``), beside its
cost model, on one NVIDIA card:

    python3 tools/plan_sweep.py

from the repository root.  At the autoencoder's 8 eigen-path products
(``matmul_rescale``: the 64 tile, K whole or split), at whisper-small's
two conv stems (``patch_factor``: the 128 and the 64 tile, the rows whole or
split), at the autoencoder's factor sides (``factor_update``, X of 8192
rows: each tile, the rows whole or split), at whisper-small's three
stacked factor shapes (``factor_update`` batched: each tile, no split) and
at ``matmul``'s three sets of shapes (each tile, K whole or split): the
gamma sweep's (3, 1001, 1001)², the autoencoder's Newton–Schulz products
(d, d)² at its factor sides and its precondition products (a, g) @ (g, g)
and (a, a) @ (a, g), and whisper-small's stacked (12, 768, 768)² and
(12, 3072, 3072)², each plan the planner weighs is forced on the wrapper in
turn and timed as ``chip_smoke.py`` times kernels: device time (a CUDA
graph of the call replayed between CUDA events) and, in brackets, eager
(CUDA events around back-to-back calls, where the host's cost of a split
shows: its workspace and its second launch).  In parentheses the model's
time; ``*`` marks the plan the planner takes.  Then ``matmul``'s two ways
of staging A on the 64 tile, at every shape of those sets where the
planner's plan stages A as rows (``gemm_plan.dense_rows16``: the 64 tile,
K % 4 == 0): as rows by 16-byte copies and k-major by 4-byte copies, in
turns.  Last, the 8 products as the eigen
path calls them (under the planner's plans, with K whole, and with A
staged k-major throughout) and the 16 factor sides as a step calls them
(under the planner's plans and with K whole).  The model's weights
(``gemm_plan._SM_FLOPS``, ``_FILL``, ``_SPLIT_S``) are fitted to these
tables.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
LAM = 1e-12       # the eigen path's lam (core/blocks/kron.py)


def table(label, name, pick, options, k, out_floats, call, sms,
          top=None) -> None:
    from repro_torch.kernels import gemm_plan
    cells = []
    top = top or gemm_plan.max_splits(k)
    for tile, tiles, blocks, fold in options:
        extra = {pick.splits} if tile == pick.tile else set()
        for s in sorted({s for s in SPLITS if s <= top} | extra):
            chunk, used = gemm_plan.chunks(k, s)
            if used != s:
                continue
            plan = gemm_plan.Plan(tile, tiles, blocks, chunk, used, fold)
            with chip_smoke.forced(name, lambda *_, plan=plan: plan):
                dev_ms = chip_smoke.graph_ms(call)
                eager = chip_smoke.eager_ms(call, reps=20)
            model = gemm_plan.cost(tile, blocks, chunk, used, sms,
                                   out_floats) * 1e3
            mark = "*" if plan == pick else " "
            cells.append(f"{mark}{tile}/{used}: {dev_ms:.4f} [{eager:.4f}] "
                         f"({model:.4f})")
    print(f"  {label} pick {pick.tile}/{pick.splits}:")
    for i in range(0, len(cells), 4):
        print("     " + ", ".join(cells[i:i + 4]))


def matmul_tables(dev, g, sms) -> None:
    """matmul's forced plans at its three sets of shapes, then its two ways
    of staging A under the planner's plans."""
    from repro_torch.configs.autoencoder import CONFIG
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.matmul import matmul, operands
    from repro_torch.models.mlp import autoencoder_dims

    dims = autoencoder_dims(CONFIG)
    layers = [(dims[i] + 1, dims[i + 1]) for i in range(len(dims) - 1)]
    sides = sorted({d for ag in layers for d in ag})
    shapes = ([("row 1", 3, 1001, 1001, 1001)]
              + [("NS", 1, d, d, d) for d in sides]
              + [("precondition", 1, a, gd, k) for a, gd in layers
                 for k in (gd, a)]
              + [("whisper NS", 12, d, d, d) for d in (768, 3072)])
    staged = []
    for label, batch, m, n, k in shapes:
        lead = (batch,) if batch > 1 else ()
        a = torch.randn(*lead, m, k, generator=g, device=dev)
        b = torch.randn(*lead, k, n, generator=g, device=dev)
        call = lambda a=a, b=b: matmul(a, b)
        op = operands("matmul", a, b)
        tiles = gemm_plan.matmul_tiles(op)
        table(f"matmul {label} {batch}x({m},{k})@({k},{n})", "dense_plan",
              gemm_plan.dense_plan(batch, m, n, k, sms, tiles),
              gemm_plan.dense_options(batch, m, n, tiles), k, batch * m * n,
              call, sms)
        if gemm_plan.dense_rows16(op, gemm_plan.dense_plan(
                batch, m, n, k, sms, tiles).tile):
            times = {True: [], False: []}
            for rows in (True, False, False, True):
                with chip_smoke.forced(
                        "dense_rows16",
                        lambda op, tile, rows=rows: rows and tile == 64):
                    times[rows].append(chip_smoke.graph_ms(call))
            staged.append((label, batch, m, n, k, times))
        del a, b
    print("  matmul's A staging on the 64 tile under the planner's plans, "
          "device ms in turns: rows by 16-byte copies / k-major by 4-byte "
          "copies")
    for label, batch, m, n, k, times in staged:
        print(f"     {label} {batch}x({m},{k})@({k},{n}): rows "
              f"{times[True][0]:.4f}, {times[True][1]:.4f} / k-major "
              f"{times[False][0]:.4f}, {times[False][1]:.4f}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("plan_sweep: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.autoencoder import CONFIG
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.factor_update import factor_update
    from repro_torch.kernels.patch_factor import (patch_factor_update,
                                                  patch_geometry)
    from repro_torch.kernels.rotate_rescale import matmul_rescale
    from repro_torch.models.mlp import autoencoder_dims

    dev = torch.device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.smi()}")
    sms = gemm_plan.sm_count(0)
    g = torch.Generator(device=dev).manual_seed(1)
    dims = autoencoder_dims(CONFIG)
    layers = [(dims[i] + 1, dims[i + 1]) for i in range(len(dims) - 1)]
    print("[plans] tile/splits: device ms [eager ms] (model ms); * the plan "
          "taken")
    mids = []
    for a, gd in layers:
        t = torch.randn(a, gd, generator=g, device=dev)
        q = torch.randn(gd, gd, generator=g, device=dev)
        sd = torch.rand(a, gd, generator=g, device=dev) + 0.05
        mids.append((t, q, sd))
        table(f"matmul_rescale ({a},{gd})@({gd},{gd})", "dense_plan",
              gemm_plan.dense_plan(1, a, gd, gd, sms),
              gemm_plan.dense_options(1, a, gd), gd, a * gd,
              lambda t=t, q=q, sd=sd: matmul_rescale(t, q, sd, LAM), sms)
    eps = torch.tensor(0.95, device=dev)
    for b, t_, c, k, st, pad, bias in chip_smoke.PATCH_CASES[-2:]:
        x = torch.randn(b, t_, c, generator=g, device=dev)
        core = k * c
        d = core + int(bias)
        rows = b * patch_geometry(x.shape, k, st, pad)[1]
        old = torch.eye(d, device=dev)
        table(f"patch_factor x{(b, t_, c)} -> {d}²", "triangle_plan",
              gemm_plan.triangle_plan(d, core, bias, rows, sms),
              gemm_plan.triangle_options(d, core, bias), rows, d * d,
              lambda x=x, old=old, k=k, st=st, pad=pad, bias=bias:
              patch_factor_update(x, old, taps=k, stride=st, padding=pad,
                                  has_bias=bias, alpha=1 - eps, beta=eps),
              sms)
        del x, old

    n_rows = chip_smoke.N_ROWS
    sides = [d for ag in layers for d in ag]
    fus = []
    for d in sides:
        x = torch.tanh(torch.randn(n_rows, d, generator=g, device=dev))
        fus.append((x, torch.eye(d, device=dev)))
    for d in sorted(set(sides)):
        x, c = fus[sides.index(d)]
        table(f"factor_update X({n_rows},{d})", "triangle_plan",
              gemm_plan.triangle_plan(d, d, False, n_rows, sms),
              gemm_plan.triangle_options(d, d, False), n_rows, d * d,
              lambda x=x, c=c: factor_update(x, c, alpha=1 - eps, beta=eps),
              sms)
    for s_, n, d in chip_smoke.FU_WHISPER:
        x = torch.tanh(torch.randn(s_, n, d, generator=g, device=dev))
        c = torch.eye(d, device=dev).expand(s_, d, d).contiguous()
        table(f"factor_update batched X({s_},{n},{d})", "triangle_plan",
              gemm_plan.triangle_plan(d, d, False, n, sms, s_),
              [(t, ts, s_ * b, f) for t, ts, b, f in
               gemm_plan.triangle_options(d, d, False)], n, s_ * d * d,
              lambda x=x, c=c: factor_update(x, c, alpha=1 - eps, beta=eps),
              sms, top=1)
        del x, c

    matmul_tables(dev, g, sms)

    def whole(batch, m, n, k, sms_):
        tile, tiles, blocks, fold = gemm_plan.dense_options(batch, m, n)[0]
        return gemm_plan.Plan(tile, tiles, blocks, *gemm_plan.chunks(k, 1),
                              fold)

    run = lambda: [matmul_rescale(t, q, sd, LAM) for t, q, sd in mids]
    picked = (chip_smoke.graph_ms(run), chip_smoke.eager_ms(run, reps=20))
    with chip_smoke.forced("dense_plan", whole):
        unsplit = (chip_smoke.graph_ms(run), chip_smoke.eager_ms(run, reps=20))
    with chip_smoke.forced("dense_rows16", lambda op, tile: False):
        kmajor = (chip_smoke.graph_ms(run), chip_smoke.eager_ms(run, reps=20))
    print(f"  the 8 products of an eigen step: planner's plans "
          f"{picked[0]:.4f} [{picked[1]:.4f}] ms, K whole {unsplit[0]:.4f} "
          f"[{unsplit[1]:.4f}] ms, A k-major throughout {kmajor[0]:.4f} "
          f"[{kmajor[1]:.4f}] ms")

    def rows_whole(d, core, has_bias, rows, sms_, batch=1):
        tile, tiles, blocks, fold = gemm_plan.triangle_options(
            d, core, has_bias)[0]
        return gemm_plan.Plan(tile, tiles, batch * blocks,
                              *gemm_plan.chunks(rows, 1), fold)

    run = lambda: [factor_update(x, c, alpha=1 - eps, beta=eps)
                   for x, c in fus]
    picked = (chip_smoke.graph_ms(run), chip_smoke.eager_ms(run, reps=20))
    with chip_smoke.forced("triangle_plan", rows_whole):
        unsplit = (chip_smoke.graph_ms(run), chip_smoke.eager_ms(run, reps=20))
    print(f"  the 16 factor sides of a step: planner's plans "
          f"{picked[0]:.4f} [{picked[1]:.4f}] ms, the 128 tile with the "
          f"rows whole {unsplit[0]:.4f} [{unsplit[1]:.4f}] ms")


if __name__ == "__main__":
    main()
