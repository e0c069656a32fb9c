"""Serving launcher: continuous batching over the paged-KV engine (mirrors
``repro/launch/serve.py``).

  python -m repro_torch.launch.serve --arch llama3.2-1b --requests 32 \\
      --slots 16 --max_len 2048 --max_new 64

runs on the card (``--device cuda``, the default; ``--device cpu`` runs
the plain PyTorch versions).  Weights are the port's own random
initialization from seed 0.  The default decode route is paged
(``--decode_route gather`` selects the dense-gather oracle); ``--num_pages``
shrinks the page pool to force eviction and preemption.  The reference's
``--uncertainty``, ``--bundle`` and ``--obs*`` flags wait for the slices
that port the Laplace head and the telemetry.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.models.lm import LM
from repro_torch.serving.server import DECODE_ROUTES, Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max_len", type=int, default=128)
    ap.add_argument("--max_new", type=int, default=8)
    ap.add_argument("--decode_route", choices=DECODE_ROUTES, default="paged")
    ap.add_argument("--page_size", type=int, default=8)
    ap.add_argument("--num_pages", type=int, default=None,
                    help="page pool size; small values force "
                         "eviction/preemption under load")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples")
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request sampling seed base (request i uses "
                         "seed+i); omit for the engine-shared generator")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    lm = LM(cfg, device=args.device)
    params = lm.init_params(torch.Generator(device=lm.device).manual_seed(0))
    eng = Engine(lm, params, batch_slots=args.slots, max_len=args.max_len,
                 page_size=args.page_size, num_pages=args.num_pages,
                 decode_route=args.decode_route)
    reqs = [Request(uid=i, prompt=[(7 * i + j) % cfg.vocab_size
                                   for j in range(4 + i % 3)],
                    max_new=args.max_new, temperature=args.temperature,
                    top_k=args.top_k, top_p=args.top_p,
                    seed=None if args.seed is None else args.seed + i)
            for i in range(args.requests)]
    rep = eng.run(reqs)
    for r in reqs:
        tag = f" (preempted x{r.preemptions})" if r.preemptions else ""
        print(f"[serve] req {r.uid}: prompt={r.prompt} -> out={r.out}{tag}")
    assert all(r.done or r.out for r in reqs)
    print(f"[serve] {rep.steps} steps ({args.decode_route} route, "
          f"{lm.device}): {len(rep.completed)} completed, "
          f"{len(rep.unfinished)} in flight, {len(rep.unserved)} queued, "
          f"{len(rep.failed)} rejected")
    print(f"[serve] decode steps {rep.decode_steps}, preemptions "
          f"{rep.preemptions}, evicted pages {rep.evictions}, sampled "
          f"{eng.n_sampled}")
    if rep.ttft_p50_ms is not None:
        print(f"[serve] ttft p50={rep.ttft_p50_ms:.2f}ms "
              f"p99={rep.ttft_p99_ms:.2f}ms (host clock)")
    return rep


if __name__ == "__main__":
    main()
