"""The plain version of the port's ``patch_factor`` kernel
(``kernels.patch_factor.patch_factor_update_ref``) and the im2col of
``models/conv.py`` against the JAX reference on the CPU.

* At the four tiled cases of ``tests/test_kernels.py::
  test_patch_factor_kernel`` the reference runs its interpret-mode Pallas
  ``patch_factor_update`` (alpha and beta traced through ``jit``).
* At the five shapes the reference's kernel declines
  (``test_patch_factor_ragged_declines``: C 13, t_out 21, C 136, taps over
  the time block, t < K) and at odd- and even-length stride-2 "SAME" convs
  (the odd pad on the high side, as whisper's conv2 at T 3000), the oracle
  is the reference's einsum route: its ``extract_patches`` +
  ``append_homog`` + ``beta·C + alpha·PᵀP``.  The port has no such gate:
  its kernel takes every shape.

Tolerance: max|port − JAX| ≤ 1e-5 · max|JAX| (float32 sums in another
order).  Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.patch_factor import conv_pad_amounts as j_pad
from repro.kernels.patch_factor import patch_factor_update as j_update
from repro.models import conv as jconv
from repro_torch.kernels import patch_factor as PF
from repro_torch.models import conv as tconv

torch.set_num_threads(1)

ALPHA, BETA = 0.03, 0.9


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(err) and err <= tol * scale, (err, scale)


def _port(x, old, k, stride, pad, bias, alpha=ALPHA, beta=BETA):
    return PF.patch_factor_update(torch.from_numpy(x), torch.from_numpy(old),
                                  taps=k, stride=stride, padding=pad,
                                  has_bias=bias, alpha=alpha, beta=beta)


def _meta(c, k, stride, pad, bias):
    return jconv.conv_meta("c", ("w",), spatial=(k,), stride=(stride,),
                           c_in=c, d_out=4, padding=pad, bias=bias)


@pytest.mark.parametrize("b,t,c,k,stride,pad,bias", [
    (2, 128, 8, 3, 1, "SAME", True),      # whisper conv1 shape family
    (2, 256, 16, 3, 2, "SAME", True),     # whisper conv2 (stride 2)
    (1, 131, 8, 4, 1, "VALID", False),    # VALID with leftover rows
    (2, 512, 128, 3, 1, "SAME", True),    # full 128-lane channel tile
])
def test_plain_version_matches_jax_pallas_kernel(b, t, c, k, stride, pad,
                                                 bias):
    meta = _meta(c, k, stride, pad, bias)
    x, old = _rand(30, (b, t, c)), _rand(31, (meta.a_dim, meta.a_dim))
    want = jax.jit(lambda a, be: j_update(jnp.asarray(x), jnp.asarray(old),
                                          meta, a, be))(
        jnp.float32(ALPHA), jnp.float32(BETA))
    assert want is not None, "the reference's kernel declined a tiled shape"
    _close(_port(x, old, k, stride, pad, bias), want)


@pytest.mark.parametrize("c,t,k,stride,pad", [
    (13, 128, 3, 1, "SAME"),     # ragged channels
    (8, 21, 3, 1, "SAME"),       # ragged output positions
    (136, 128, 3, 1, "SAME"),    # channels over the 128-lane tile
    (8, 8, 9, 1, "SAME"),        # taps exceed the time block
    (8, 2, 3, 1, "VALID"),       # t < k: zero output positions
    (8, 31, 3, 2, "SAME"),       # odd length, stride 2: pads (1, 1)
    (6, 30, 3, 2, "SAME"),       # even length, stride 2: pads (0, 1)
])
def test_plain_version_matches_jax_einsum_route(c, t, k, stride, pad):
    """Where the reference's kernel returns None, its ConvKronecker takes
    explicit patches; the port's plain version must agree with that."""
    meta = _meta(c, k, stride, pad, True)
    x, old = _rand(32, (2, t, c)), _rand(33, (meta.a_dim, meta.a_dim))
    if stride == 1:
        assert j_update(jnp.asarray(x), jnp.asarray(old), meta, ALPHA,
                        BETA) is None
    p = jconv.extract_patches(jnp.asarray(x), (k,), (stride,), pad)
    p = jconv.append_homog(p.reshape(-1, p.shape[-1]))
    want = BETA * jnp.asarray(old) + ALPHA * p.T @ p
    _close(_port(x, old, k, stride, pad, True), want)


@pytest.mark.parametrize("t,k,stride,pad", [
    (3000, 3, 2, "SAME"), (3000, 3, 1, "SAME"), (31, 3, 2, "SAME"),
    (8, 9, 1, "SAME"), (131, 4, 1, "VALID"), (2, 3, 1, "VALID")])
def test_geometry_and_patches_match_jax(t, k, stride, pad):
    """conv_pad_amounts / conv_out_len and the tap-major im2col (the
    reference transposes lax's channel-major patches)."""
    assert tconv.conv_pad_amounts(t, k, stride, pad) == j_pad(t, k, stride,
                                                               pad)
    assert tconv.conv_out_len(t, k, stride, pad) == jconv.conv_out_len(
        t, k, stride, pad)
    if t > 512:
        return
    x = _rand(34, (2, t, 5))
    want = jconv.extract_patches(jnp.asarray(x), (k,), (stride,), pad)
    got = tconv.extract_patches(torch.from_numpy(x), (k,), (stride,), pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_whisper_conv2_pads_the_high_side():
    """lax "SAME" at T 3000, k 3, s 2 pads (0, 1): the last output reads
    frames 2998, 2999 and one zero."""
    assert tconv.conv_pad_amounts(3000, 3, 2, "SAME") == (0, 1)
    x = torch.arange(1.0, 3001.0).reshape(1, 3000, 1)
    p = tconv.extract_patches(x, (3,), (2,), "SAME")
    assert p.shape == (1, 1500, 3)
    assert p[0, 0].tolist() == [1.0, 2.0, 3.0]
    assert p[0, -1].tolist() == [2999.0, 3000.0, 0.0]


def test_conv_layer_matches_jax():
    """The tagged conv's output ``patches @ W[:-1] + W[-1]``."""
    from repro.core.tags import Tagger as JTagger
    from repro_torch.core.tags import Tagger
    x, w = _rand(35, (2, 31, 6)), _rand(36, (3 * 6 + 1, 5))
    want = jconv.conv(JTagger(), "c", jnp.asarray(w), jnp.asarray(x),
                      spatial=(3,), stride=(2,), padding="SAME")
    got = tconv.conv(Tagger(), "c", torch.from_numpy(w), torch.from_numpy(x),
                     spatial=(3,), stride=(2,), padding="SAME")
    _close(got.numpy(), want)
