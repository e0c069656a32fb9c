"""The port's plain decode versions against the JAX package's Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and its
einsum oracle ``ops.flash_decode_ref``, on the same seeded numpy inputs.

K/V are rounded to bfloat16 once and shared by both sides (the caches the
kernels read are bf16); q is float32.  GQA groups 1–4, ragged per-row
lengths (1, a page, a page + 1, mid-page, the whole cache), sliding
windows and softcaps, page sizes 4 and 8, shuffled page tables.
Tolerance: max|port − JAX| ≤ 1e-5 · max|JAX| (float32 sums in another
order).  The CUDA kernels are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro.kernels.flash_decode import flash_decode_paged as j_paged
from repro_torch import kernels as K
from repro_torch.kernels import flash_decode as FD

TOL = 1e-5
HKV, HD = 2, 32
WINDOW_CAP = [(0, 0.0), (6, 0.0), (0, 25.0), (5, 30.0)]


def _inputs(seed, b, hq, kv_shape):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, HD)).astype(np.float32)
    kv = [np.asarray(jnp.asarray(rng.standard_normal(kv_shape), jnp.bfloat16)
                     .astype(jnp.float32)) for _ in range(2)]
    return q, kv[0], kv[1]


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    return jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(err) and err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_flash_decode_ref_matches_pallas(group, window, cap):
    b, s_len = 4, 256
    q, k, v = _inputs(group, b, group * HKV, (b, HKV, s_len, HD))
    lengths = np.asarray([1, 77, 200, 256], np.int32)
    want = j_flash_decode(_j(q), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
                          _j(lengths), bk=128, window=window, cap=cap,
                          interpret=True)
    got = FD.flash_decode_ref(_t(q), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), _t(lengths),
                              window=window, cap=cap)
    _close(got, want)
    oracle = ops.flash_decode_ref(_j(q), _j(k, jnp.bfloat16),
                                  _j(v, jnp.bfloat16), _j(lengths),
                                  window=window, cap=cap)
    _close(got, oracle)


def _paged(seed, page, nb, b, hq):
    num_pages = 1 + b * nb
    q, kp, vp = _inputs(seed, b, hq, (num_pages, page, HKV, HD))
    table = np.random.default_rng(seed + 1).permutation(
        np.arange(1, num_pages)).reshape(b, nb).astype(np.int32)
    lengths = np.asarray([1, page, page + 1, 3 * page + 2, nb * page],
                         np.int32)[:b]
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("group", [1, 2, 3, 4])
@pytest.mark.parametrize("page", [4, 8])
def test_flash_decode_paged_ref_matches_pallas(page, group, window, cap):
    q, kp, vp, table, lengths = _paged(10 * page + group, page, nb=4, b=5,
                                       hq=group * HKV)
    want = j_paged(_j(q), _j(kp, jnp.bfloat16), _j(vp, jnp.bfloat16),
                   _j(lengths), _j(table), bh=1, window=window, cap=cap,
                   interpret=True)
    got = FD.flash_decode_paged_ref(_t(q), _t(kp, torch.bfloat16),
                                    _t(vp, torch.bfloat16), _t(lengths),
                                    _t(table), window=window, cap=cap)
    _close(got, want)


def test_paged_gather_matches_reference():
    q, kp, vp, table, _ = _paged(3, 4, nb=3, b=2, hq=2)
    jk, jv = ops.paged_gather(_j(kp), _j(vp), _j(table))
    tk, tv = FD.paged_gather(_t(kp), _t(vp), _t(table))
    assert tuple(tk.shape) == jk.shape == (2, HKV, 12, HD)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("paged", [False, True])
def test_rows_without_a_valid_key_mirror_the_reference(paged):
    """len < 1, or a window that ends past the cache: the reference's scores
    are all −1e30 and its softmax uniform, so the output is the mean of V
    over every walked key.  The port mirrors this (docstring of
    ``kernels/flash_decode.py``)."""
    lengths = np.asarray([0, -3, 1], np.int32)
    if paged:
        q, kp, vp, table, _ = _paged(5, 4, nb=3, b=3, hq=2 * HKV)
        want = j_paged(_j(q), _j(kp, jnp.bfloat16), _j(vp, jnp.bfloat16),
                       _j(lengths), _j(table), interpret=True)
        got = FD.flash_decode_paged(_t(q), _t(kp, torch.bfloat16),
                                    _t(vp, torch.bfloat16), _t(lengths),
                                    _t(table))
        _, vd = FD.paged_gather(_t(kp), _t(vp), _t(table))
    else:
        q, k, v = _inputs(6, 3, 2 * HKV, (3, HKV, 128, HD))
        want = j_flash_decode(_j(q), _j(k, jnp.bfloat16),
                              _j(v, jnp.bfloat16), _j(lengths), bk=128,
                              interpret=True)
        got = FD.flash_decode(_t(q), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), _t(lengths))
        vd = _t(v)
    _close(got, want)
    mean_v = vd.float().mean(dim=2).repeat_interleave(2, dim=1)  # (B,Hq,hd)
    _close(got[:2], mean_v[:2])


def test_scalar_length_broadcasts():
    q, k, v = _inputs(8, 2, 4, (2, HKV, 128, HD))
    want = ops.flash_decode_ref(_j(q), _j(k), _j(v), 50)
    _close(FD.flash_decode(_t(q), _t(k, torch.bfloat16),
                           _t(v, torch.bfloat16), 50), want)


def test_dense_view_through_strides():
    """The LM hands the kernel its (B, S, Hkv, hd) cache transposed to
    (B, Hkv, S, hd) without a copy; the plain version reads the view."""
    q, k, v = _inputs(9, 3, 4, (3, 64, HKV, HD))
    lengths = np.asarray([3, 64, 40], np.int32)
    kt = _t(k, torch.bfloat16).transpose(1, 2)
    vt = _t(v, torch.bfloat16).transpose(1, 2)
    assert not kt.is_contiguous()
    want = ops.flash_decode_ref(_j(q), _j(k).transpose(0, 2, 1, 3),
                                _j(v).transpose(0, 2, 1, 3), _j(lengths),
                                window=20, cap=10.0)
    _close(FD.flash_decode(_t(q), kt, vt, _t(lengths), window=20, cap=10.0),
           want)


def test_cpu_tensors_launch_nothing():
    K.reset_launches()
    q, kp, vp, table, lengths = _paged(11, 4, nb=2, b=2, hq=2)
    FD.flash_decode_paged(_t(q), _t(kp, torch.bfloat16),
                          _t(vp, torch.bfloat16), _t(lengths), _t(table))
    kd, vd = FD.paged_gather(_t(kp, torch.bfloat16), _t(vp, torch.bfloat16),
                             _t(table))
    FD.flash_decode(_t(q), kd, vd, _t(lengths))
    assert FD.flash_decode.launches == FD.flash_decode_paged.launches == 0
    assert set(K.launches().values()) == {0}


def test_only_cpu_tensors_take_the_plain_versions():
    """A tensor on any other device than the CPU goes to the kernel's
    checks, which raise for anything but CUDA; it never reaches the plain
    version."""
    meta = dict(device="meta")
    q = torch.zeros(2, 4, 16, **meta)
    kv = torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16, **meta)
    pool = torch.zeros(3, 4, 2, 16, dtype=torch.bfloat16, **meta)
    lengths = torch.ones(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        FD.flash_decode(q, kv, kv, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        FD.flash_decode_paged(q, pool, pool, lengths,
                              torch.zeros(2, 2, dtype=torch.int32, **meta))
