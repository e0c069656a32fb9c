#!/usr/bin/env python3
"""Device and eager times of the decode kernels at each n_split, beside the
split rule's own choice, on one NVIDIA card:

    python3 tools/decode_sweep.py

from the repository root.  ``kernels/flash_decode.py::decode_splits`` is
forced to each n_split in turn (the wrapper's ``last_split`` confirms the
launch) and the call is timed as ``chip_smoke.py`` times kernels: device
time (a CUDA graph of the call replayed between CUDA events) and, in
brackets, eager (CUDA events around back-to-back calls, where a split's
workspace and second launch show).  ``*`` marks the rule's choice, found by
calling the wrapper unforced.  Shapes: ``chip_smoke.py``'s two timing cases
(16 rows, lengths 1..S drawn at random; llama3.2-1b Hq 32, Hkv 8, hd 64,
S 4096; gemma2-2b Hq 8, Hkv 4, hd 256, S 8192, window 4096, softcap 50),
dense and paged, and the serve phase's decode steps, paged: llama3.2-1b's
first 16 prompts 32 tokens into their answers in a cache of 2048, and
gemma2-2b's 16 prompts 16 tokens in, in a cache of 8192, on a local layer
(window 4096) and a global one, softcap 50.  Pages of 8 keys, shuffled.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)

SPLITS = (1, 2, 3, 4, 6, 8, 9, 12, 16, 17, 24, 32)
PAGE = 8


@contextlib.contextmanager
def forced(n_split: int):
    """Make the split rule return ``n_split`` inside."""
    from repro_torch.kernels import flash_decode as FD
    keep = FD.decode_splits
    FD.decode_splits = lambda pairs, span, sms: n_split
    try:
        yield
    finally:
        FD.decode_splits = keep


def operands(g, hq, hkv, hd, s_len, lengths):
    """q, a dense (B, Hkv, S, hd) bf16 cache read through the LM's (B, S,
    Hkv, hd) strides, page pools of PAGE keys with a shuffled page table,
    and the lengths, on the card."""
    b = len(lengths)
    q = torch.randn(b, hq, hd, generator=g, device="cuda")
    k, v = (torch.randn(b, s_len, hkv, hd, generator=g, device="cuda")
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    nb = s_len // PAGE
    kp, vp = (torch.randn(1 + b * nb, PAGE, hkv, hd, generator=g,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    table = (torch.randperm(b * nb, generator=g, device="cuda") + 1
             ).reshape(b, nb).to(torch.int32)
    n = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, kp, vp, table, n


def sweep(label, routes, bound) -> None:
    print(f"  {label}; bound {bound[0]:.4f} ms ({bound[1]})")
    for name, (wrapper, call) in routes.items():
        call()
        pick = wrapper.last_split
        cells = []
        for n_split in sorted(set(SPLITS) | {pick}):
            with forced(n_split):
                dev_ms = chip_smoke.graph_ms(call)
                eager = chip_smoke.eager_ms(call, reps=20)
                if wrapper.last_split != n_split:
                    raise AssertionError(f"{name}: launched n_split "
                                         f"{wrapper.last_split}, forced "
                                         f"{n_split}")
            mark = "*" if n_split == pick else " "
            cells.append(f"{mark}{n_split}: {dev_ms:.4f} [{eager:.4f}]")
        print(f"    {name}:")
        for i in range(0, len(cells), 4):
            print("      " + ", ".join(cells[i:i + 4]))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("decode_sweep: torch.cuda.is_available() is False")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged)
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.smi()}")
    print("[decode] n_split: device ms [eager ms]; * the rule's choice")
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    timing = [("llama3.2-1b", 32, 8, 64, 4096, 0, 0.0),
              ("gemma2-2b", 8, 4, 256, 8192, 4096, 50.0)]
    for arch, hq, hkv, hd, s_len, window, cap in timing:
        lengths = rng.integers(1, s_len + 1, 16).tolist()
        lengths[0], lengths[-1] = 1, s_len
        q, k, v, kp, vp, table, n = operands(g, hq, hkv, hd, s_len, lengths)
        kw = dict(window=window, cap=cap)
        sweep(f"{arch} timing case, 16 rows, lengths 1-{s_len}, window "
              f"{window}, cap {cap}",
              {"flash_decode": (flash_decode, lambda: flash_decode(
                  q, k, v, n, **kw)),
               "flash_decode_paged": (flash_decode_paged,
                                      lambda: flash_decode_paged(
                                          q, kp, vp, n, table, **kw))},
              chip_smoke.decode_bound(n, s_len, hq, hkv, hd, PAGE, window))
        del q, k, v, kp, vp, table, n
    # the serve phase's requests (chip_smoke.py, phase 6)
    llama = np.random.default_rng(0).permutation(
        np.linspace(64, 1024, 32).astype(int))[:16] + 32
    gemma = np.array([6000, 5000] + list(np.random.default_rng(1).permutation(
        np.linspace(64, 4096, 14).astype(int)))) + 16
    serving = [("llama3.2-1b", 32, 8, 64, 2048, llama, ((0, 0.0),)),
               ("gemma2-2b", 8, 4, 256, 8192, gemma,
                ((4096, 50.0), (0, 50.0)))]
    for arch, hq, hkv, hd, s_len, lengths, layers in serving:
        q, _, _, kp, vp, table, n = operands(g, hq, hkv, hd, s_len,
                                             lengths.tolist())
        for window, cap in layers:
            kw = dict(window=window, cap=cap)
            sweep(f"{arch} serving, 16 rows, lengths {lengths.min()}-"
                  f"{lengths.max()}, cache {s_len}, window {window}, cap "
                  f"{cap}",
                  {"flash_decode_paged": (flash_decode_paged,
                                          lambda: flash_decode_paged(
                                              q, kp, vp, n, table, **kw))},
                  chip_smoke.decode_bound(n, s_len, hq, hkv, hd, PAGE,
                                          window))
        del q, kp, vp, table, n


if __name__ == "__main__":
    main()
