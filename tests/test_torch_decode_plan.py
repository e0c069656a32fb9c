"""The host's split rule of the flash-decode kernels
(``repro_torch/kernels/flash_decode.py::decode_splits``), checked on the
CPU: one split where B·Hkv already fills the card, more splits as B·Hkv
falls, never a planned chunk shorter than ``MIN_CHUNK`` keys, and no
input that holds the lengths (they stay on the device).  Whether the
kernels walk the chunks as planned is the card tests' to show
(``tests/test_torch_cuda.py``).
"""
import inspect
import re
from pathlib import Path

import pytest

from repro_torch.kernels import flash_decode as FD

CSRC = (Path(FD.__file__).resolve().parent.parent / "csrc"
        / "flash_decode.cu")

# (B, Hkv, S, window): llama3.2-1b's and gemma2-2b's serving shapes, the
# card tests' shapes, and the most splits (one row, one KV head)
SHAPES = [(16, 8, 4096, 0), (16, 8, 2048, 0), (16, 4, 8192, 4096),
          (16, 4, 8192, 0), (1, 1, 8192, 0), (2, 2, 2048, 0), (4, 4, 2048, 700),
          (72, 8, 512, 0), (3, 2, 200, 37), (1, 1, 40, 0)]
SMS = [132, 114, 78, 16]   # H100 SXM, H100 PCIe, a part-disabled card, a toy


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,hkv,s_len,window", SHAPES)
def test_one_split_where_the_pairs_fill_the_card(b, hkv, s_len, window, sms):
    span = FD.key_span(s_len, window)
    pairs = b * hkv
    n_split = FD.decode_splits(pairs, span, sms)
    if pairs >= FD.FILL * sms:
        assert n_split == 1
    else:
        # either the card gets FILL blocks an SM, or the span has no room
        # for another MIN_CHUNK-key chunk
        assert pairs * n_split >= FD.FILL * sms or (
            n_split == max(1, span // FD.MIN_CHUNK))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("span", [1, 255, 256, 700, 4096, 8192, 100000])
def test_more_splits_as_the_pairs_fall(span, sms):
    counts = [FD.decode_splits(p, span, sms)
              for p in range(1, 2 * FD.FILL * sms)]
    assert all(a >= b for a, b in zip(counts, counts[1:]))
    assert counts[-1] == 1
    assert counts[0] == max(1, min(FD.FILL * sms, span // FD.MIN_CHUNK))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("span", [1, 100, 255, 256, 511, 512, 700, 4095,
                                  4096, 8192, 65536])
def test_no_planned_chunk_shorter_than_the_minimum(span, sms):
    for pairs in (1, 2, 3, 7, 16, 64, 128, 527, 528, 1000):
        n_split = FD.decode_splits(pairs, span, sms)
        assert n_split >= 1
        if n_split > 1:
            assert span // n_split >= FD.MIN_CHUNK


@pytest.mark.parametrize("s_len,window,want", [(4096, 0, 4096),
                                               (8192, 4096, 4096),
                                               (2048, 4096, 2048),
                                               (300, -1, 300)])
def test_key_span_clips_to_the_window(s_len, window, want):
    assert FD.key_span(s_len, window) == want


def test_the_rule_reads_no_lengths():
    """The rule's inputs are shapes and the SM count; the wrappers' CUDA
    paths read nothing back from the device (no ``.item()``, ``.tolist()``
    or ``.cpu()``), so a decode step never waits for the card."""
    assert list(inspect.signature(FD.decode_splits).parameters) == [
        "pairs", "span", "sms"]
    assert list(inspect.signature(FD.key_span).parameters) == [
        "s_len", "window"]
    for fn in (FD.flash_decode, FD.flash_decode_paged, FD._check,
               FD._split, FD.decode_splits, FD.key_span):
        src = inspect.getsource(fn)
        for call in (".item(", ".tolist(", ".cpu("):
            assert call not in src, (fn.__name__, call)


def test_the_rule_plans_with_the_kernels_shortest_chunk():
    """The kernel cuts chunks of at least ``kMinChunk`` keys; the rule
    plans with ``MIN_CHUNK``: one number."""
    found = re.findall(r"constexpr int kMinChunk = (\d+);", CSRC.read_text())
    assert found == [str(FD.MIN_CHUNK)]
