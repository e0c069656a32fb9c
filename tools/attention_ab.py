#!/usr/bin/env python3
"""flash_attention at the serving prefill's three timed shapes, from one or
more checkouts in turn, on one NVIDIA card:

    python3 tools/attention_ab.py CHECKOUT [CHECKOUT ...]

from the repository root.  Each CHECKOUT is a directory holding a copy of
the repository: ``.`` for this one, or another commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists (``build/ab/parent``).
Each runs in a process of its own, in the order given (parent, tree, tree,
parent to compare two), builds its kernels into its own ``build/`` and
imports its own ``repro_torch``; the timing code is this checkout's
(``chip_smoke.graph_ms`` and ``eager_ms``, ``chip_smoke.attention_bound``).
The shapes are ``chip_smoke.py``'s (llama3.2-1b's 1024-token layer, B 1,
Hq 32, Hkv 8, hd 64, causal; gemma2-2b's 6000-token local and global
layers, Hq 8, Hkv 4, hd 256, softcap 50, window 4096 or none) on q, k, v
made from one seed, as the LM passes them.  Per checkout and shape: device
ms (a CUDA graph of one call replayed between CUDA events), the median and
the least of five readings, eager ms, max|kernel - plain| / max|plain|,
and the share of the bound.  The last line is a JSON object of every
reading.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = {"llama3.2-1b": (1, 32, 8, 64, 1024, dict(causal=True)),
          "gemma2-2b local": (1, 8, 4, 256, 6000,
                              dict(causal=True, window=4096, cap=50.0)),
          "gemma2-2b global": (1, 8, 4, 256, 6000,
                               dict(causal=True, cap=50.0))}
READINGS = 5


def child(checkout: Path) -> dict:
    """Time the shapes with ``checkout``'s kernels (run in its own
    process)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke                      # puts this checkout's src/ first
    sys.path.insert(0, str(checkout.resolve() / "src"))
    import torch

    from repro_torch.kernels import flash_attention as FA
    if not Path(FA.__file__).resolve().is_relative_to(checkout.resolve()):
        raise RuntimeError(f"imported {FA.__file__}, not {checkout}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for label, (b, hq, hkv, hd, t, kw) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(b, t, hq, hd, generator=g, device="cuda")
        k, v = (torch.randn(b, t, hkv, hd, generator=g, device="cuda")
                for _ in range(2))
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        want = FA.flash_attention_ref(q, k, v, **kw)
        err = ((FA.flash_attention(q, k, v, **kw) - want).abs().max()
               / want.abs().max()).item()
        del want

        def call(q=q, k=k, v=v, kw=kw):
            return FA.flash_attention(q, k, v, **kw)

        ms = [chip_smoke.graph_ms(call) for _ in range(READINGS)]
        bound = chip_smoke.attention_bound(b, hq, hkv, hd, t, t,
                                           kw["causal"], kw.get("window", 0))
        out[label] = dict(ms=ms, median_ms=statistics.median(ms),
                          min_ms=min(ms), eager_ms=chip_smoke.eager_ms(call),
                          rel_err=err, bound_ms=bound[0], bound_by=bound[1])
    return out


def main(argv) -> None:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(Path(argv[1]))))
        return
    if not argv:
        sys.exit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    runs = []
    for checkout in argv:
        res = subprocess.run([sys.executable, __file__, "--child",
                              str(Path(checkout).resolve())],
                             capture_output=True, text=True, cwd=ROOT)
        if res.returncode:
            sys.exit(f"{checkout} failed:\n{res.stdout}\n{res.stderr}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(dict(checkout=checkout, shapes=r))
        for label, x in r.items():
            print(f"  {checkout:24s} {label:17s} device {x['median_ms']:.4f} "
                  f"ms (min {x['min_ms']:.4f}) [eager {x['eager_ms']:.4f}], "
                  f"bound {x['bound_ms']:.4f} ms "
                  f"({100 * x['bound_ms'] / x['median_ms']:.1f}%), "
                  f"err/max {x['rel_err']:.2e}", flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main(sys.argv[1:])
