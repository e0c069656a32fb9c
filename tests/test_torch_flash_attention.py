"""The port's ``flash_attention`` on CPU tensors (its plain version, the
query-chunked attention) against the JAX package's Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` runs it) at shapes that tile,
and against its oracle ``repro.kernels.ref.flash_attention_ref`` at ragged
lengths, with Tk < Tq and Tk > Tq, and on rows with no valid key.

The same seeded numpy inputs go to both sides.  GQA groups 1–4, causal or
not, a sliding window and a score softcap, head dims 16, 64, 128 and 256
(gemma2's).
Tolerance: max|port − JAX| ≤ 1e-5 · max|JAX| (float32 sums in another
order).  The CUDA kernel is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.ref import flash_attention_ref as j_ref
from repro_torch import kernels as K
from repro_torch.kernels import flash_attention as FA

TOL = 1e-5
HKV = 2
# (causal, window, cap, hd)
CASES = [(True, 0, 0.0, 16), (True, 12, 0.0, 64), (False, 0, 30.0, 16),
         (True, 9, 20.0, 64), (False, 10, 0.0, 64),
         (True, 20, 30.0, 128), (True, 0, 50.0, 256), (False, 7, 50.0, 256)]


def _inputs(seed, b, hq, tq, tk, hd, hkv=HKV):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, tk, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(err) and err <= TOL * scale, (err, scale)


def _port(q, k, v, **kw):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    return FA.flash_attention(*t, **kw).numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_plain_version_matches_pallas_kernel(group, case):
    """Tq = Tk = 48 in tiles of 16 queries and 16 keys."""
    causal, window, cap, hd = case
    q, k, v = _inputs(group * 10 + hd, 2, group * HKV, 48, 48, hd)
    kw = dict(causal=causal, window=window, cap=cap)
    want = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bq=16, bk=16, interpret=True, **kw)
    _close(_port(q, k, v, **kw), want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tq,tk,group", [(7, 7, 1), (7, 7, 3),
                                         (300, 300, 2), (300, 300, 4),
                                         (40, 25, 2), (25, 40, 3)])
def test_plain_version_matches_oracle_at_ragged_lengths(tq, tk, group, case):
    """Lengths no tile divides (300 runs in query chunks of 256 + 44), Tk
    < Tq and Tk > Tq (query i and key j at positions i and j)."""
    causal, window, cap, hd = case
    q, k, v = _inputs(tq + tk + group, 1, group * HKV, tq, tk, hd)
    kw = dict(causal=causal, window=window, cap=cap)
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(_port(q, k, v, **kw), want)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_with_no_valid_key_give_the_mean_of_v(causal):
    """With a window and Tk < Tq, queries i >= Tk + window - 1 see no key:
    the reference's all −1e30 scores make their softmax uniform over all
    Tk keys, so their output is the mean of V."""
    tq, tk, window = 40, 12, 6
    q, k, v = _inputs(5, 2, 4, tq, tk, 16)
    kw = dict(causal=causal, window=window, cap=25.0)
    got = _port(q, k, v, **kw)
    _close(got, j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    empty = tk + window - 1
    mean = np.repeat(v.mean(axis=2, keepdims=True), 2, axis=1)  # G = 2
    np.testing.assert_allclose(got[:, :, empty:],
                               np.broadcast_to(mean, got[:, :, empty:].shape),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[:, :, empty - 1], mean[:, :, 0])


def test_wrapper_takes_views_and_counts_no_launch_on_the_cpu():
    """The LM passes (B, T, H, hd) projections as ``.transpose(1, 2)``
    views; on CPU tensors the wrapper is the plain version and launches
    nothing.  The wrapper is registered with its counter."""
    assert K.WRAPPERS["flash_attention"] is FA.flash_attention
    q, k, v = _inputs(9, 2, 6, 33, 33, 16, hkv=3)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  .transpose(1, 2) for x in (q, k, v))
    assert not tq.is_contiguous()
    before = FA.flash_attention.launches
    got = FA.flash_attention(tq, tk, tv, window=5, cap=10.0).numpy()
    assert FA.flash_attention.launches == before
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=5,
                 cap=10.0)
    _close(got, want)
