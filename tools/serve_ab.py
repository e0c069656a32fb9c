#!/usr/bin/env python3
"""An A/B of the serve path between two checkouts on one NVIDIA card:

    python3 tools/serve_ab.py A B [--pairs 10] [--reps 2]

from the repository root, A and B being checkouts of this repository (for
the parent commit, ``git archive`` unpacked into ``build/ab/parent``; for
this tree, ``.``).  Each pair runs one process in A and one in B, A first in
even pairs and B first in odd ones.  A process serves ``chip_smoke.py``'s
serve phase's requests with that checkout's own ``chip_smoke.serve_run``
(its launch counts held exact): full-width llama3.2-1b, 32 prompts of
64..1024 tokens, 64 new tokens each, through 16 slots of 2048; then
full-width gemma2-2b, 16 prompts up to 6000 tokens, 32 new each, 16 slots
of 8192; each after a warmup run, ``--reps`` times, the weights from seed
0.  Before them, the host's time per ``flash_decode_paged`` call at each
model's serving shapes (16 rows of one key, 200 calls back to back).  It
prints, per checkout, that and each run's decode-step median (host clock),
tokens/s and TTFT p50 / p99; then, for each metric, the median over each
checkout's processes of a process's mean over its reps, B's less A's, and
in how many pairs B's came out above A's.  The token streams of every run
are compared with the first run's of A.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

METRICS = ("decode_step_ms_median", "tokens_per_s", "ttft_p50_ms",
           "ttft_p99_ms")

# Runs inside the checkout (its chip_smoke.py puts its own src/ on the
# path); the requests are those of chip_smoke.py's serve phase.
CHILD = r"""
import hashlib, json, sys, time
import numpy as np, torch
import chip_smoke as c
from repro_torch.configs import get_config
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.models.lm import LM
reps = int(sys.argv[1])
out = {"host_us": {}}
# the host's time per paged decode call at each model's serving shapes,
# 16 rows of one key each (next to no device work)
for arch, hq, hkv, hd, s_len, kw in (
        ("llama3.2-1b", 32, 8, 64, 2048, {}),
        ("gemma2-2b", 8, 4, 256, 8192, dict(window=4096, cap=50.0))):
    pool = torch.randn(2, 8, hkv, hd, device="cuda").to(torch.bfloat16)
    q = torch.randn(16, hq, hd, device="cuda")
    ones = torch.ones(16, dtype=torch.int32, device="cuda")
    table = torch.zeros(16, s_len // 8, dtype=torch.int32, device="cuda")
    call = lambda: flash_decode_paged(q, pool, pool, ones, table, **kw)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    out["host_us"][arch] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
runs = {
    "llama3.2-1b": (np.random.default_rng(0).permutation(
        np.linspace(64, 1024, 32).astype(int)), 64,
        dict(batch_slots=16, max_len=2048, page_size=8)),
    "gemma2-2b": ([6000, 5000] + list(np.random.default_rng(1).permutation(
        np.linspace(64, 4096, 14).astype(int))), 32,
        dict(batch_slots=16, max_len=8192, page_size=8)),
}
for arch, (lengths, max_new, kw) in runs.items():
    cfg = get_config(arch)
    lm = LM(cfg, device="cuda")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0))
    c.serve_run(f"{arch} warmup", lm, params,
                c.serve_requests(cfg, [64, 100], 2, seed=9), **kw)
    out[arch] = []
    for _ in range(reps):
        rep, tokens = c.serve_run(arch, lm, params,
                                  c.serve_requests(cfg, lengths, max_new),
                                  **kw)
        row = {k: rep[k] for k in %r}
        row["tokens"] = hashlib.sha256(
            json.dumps(tokens).encode()).hexdigest()[:16]
        out[arch].append(row)
    del lm, params
    torch.cuda.empty_cache()
print("AB " + json.dumps(out))
""" % (METRICS,)


def run(checkout: Path, reps: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD, str(reps)],
                          cwd=checkout, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"serve_ab: the run in {checkout} failed "
                         f"({proc.returncode})")
    line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")][-1]
    out = json.loads(line[3:])
    host = out.pop("host_us")
    print(f"  {checkout}: {time.perf_counter() - t0:.1f} s; " + "; ".join(
        f"{arch} host {host[arch]:.2f} us a paged call, " + ", ".join(
            f"{r['decode_step_ms_median']:.3f} ms {r['tokens_per_s']:.1f} "
            f"tok/s ttft {r['ttft_p50_ms']:.1f}/{r['ttft_p99_ms']:.1f}"
            for r in rows) for arch, rows in out.items()), flush=True)
    for arch, us in host.items():
        out[arch] = [dict(r, host_us=us) for r in out[arch]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    print(f"[device] {chip_smoke.smi()}")
    got = {"A": [], "B": []}
    for i in range(args.pairs):
        order = ("A", "B") if i % 2 == 0 else ("B", "A")
        print(f"[pair {i}] {' then '.join(order)}", flush=True)
        for side in order:
            got[side].append(run(args.a if side == "A" else args.b,
                                 args.reps))
    first = {arch: rows[0]["tokens"] for arch, rows in got["A"][0].items()}
    summary = {}
    for arch in first:
        same = all(r["tokens"] == first[arch] for side in got.values()
                   for proc in side for r in proc[arch])
        print(f"[{arch}] token streams equal in every run: {same}")
        summary[arch] = {"tokens_equal": same}
        for m in (*METRICS, "host_us"):
            per = {side: [statistics.fmean(r[m] for r in proc[arch])
                          for proc in got[side]] for side in got}
            med = {side: statistics.median(per[side]) for side in got}
            above = sum(b > a for a, b in zip(per["A"], per["B"]))
            print(f"  {m}: A median {med['A']:.3f}, B median "
                  f"{med['B']:.3f}, B - A {med['B'] - med['A']:+.3f}; B above "
                  f"A in {above} of {len(per['A'])} pairs; A "
                  f"{min(per['A']):.3f}-{max(per['A']):.3f}, B "
                  f"{min(per['B']):.3f}-{max(per['B']):.3f}")
            summary[arch][m] = {"A": per["A"], "B": per["B"],
                                "median_A": med["A"], "median_B": med["B"]}
    print(json.dumps({"serve_ab": summary}))


if __name__ == "__main__":
    main()
