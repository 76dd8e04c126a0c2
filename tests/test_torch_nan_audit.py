"""A NaN through K2 (conv2d) and K3 (swa_decode): the port against the reference.

conv2d: a NaN input pixel reaches every output whose window covers it
(a zero tap times NaN is NaN) in the jnp oracle
(``repro.kernels.ref.conv2d_ref``), in ``conv2d_plain`` and in both
kernels compiled for the host under the shim of
``tests/test_torch_kernel_host.py``: NaN positions equal, every other
pixel as the NaN-free comparisons hold it (bit for bit against the plain
version, the oracle within 32 ULP at the array's scale).

swa_decode (no host build: its split and combine arithmetic is mirrored
in torch by ``tests/test_torch_swa_split.py::split_mirror``):

* a NaN in a valid K row makes that row's score NaN for the heads of its
  group: the oracle, ``swa_decode_plain`` and the kernel's arithmetic
  give NaN for those heads (the kernel's fmaxf skips it in the running
  max, but ``exp(NaN - m)`` reaches the sum) and agree elsewhere;
* a NaN in V at a masked ring slot: the reference multiplies the masked
  slot's weight, 0, by V (``swa_decode.py:40-45``), so its output and the
  plain version's, which takes the same product, are NaN for the group;
  the kernel reads only valid slots and gives finite values. This is a
  fault of the port against the reference (``ROADMAP.md`` C.3), stated
  here; ``tests/test_torch_cuda.py`` states it for the kernel itself.
* a NaN in K at a masked slot: masked before the max, in every version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import conv2d_stencil
from repro_torch.kernels import swa_decode as swa
from test_torch_kernel_host import host_conv2d  # noqa: F401  (fixture)
from test_torch_nan import assert_equal_nan_positions, assert_oracle_close
from test_torch_swa_split import split_mirror


@pytest.mark.parametrize("k", [(3, 3), (5, 5), (1, 5), (9, 9)])
def test_conv2d_passes_a_nan_on_like_the_reference(host_conv2d, k):
    """NaN pixels (inside, on the first row and column, at the last
    column) through the row kernel (3x3, 5x5, 1x5) and the tile kernel
    (9x9), at a scalar and a vector width."""
    rng = np.random.RandomState(30)
    for h, w in [(21, 130), (19, 520)]:
        img = rng.rand(h, w).astype(np.float32)
        img[7, 9] = img[0, 3] = img[12, 0] = img[15, w - 1] = np.nan
        wts = rng.randn(*k).astype(np.float32)
        plain = conv2d_stencil.conv2d_plain(torch.from_numpy(img),
                                            torch.from_numpy(wts)).numpy()
        assert np.isnan(plain).any() and not np.isnan(plain).all()
        got, _ = host_conv2d(img, wts, 8)
        assert_equal_nan_positions(got, plain)
        assert_oracle_close(plain, np.asarray(jref.conv2d_ref(
            jnp.asarray(img), jnp.asarray(wts))))


SWA_SHAPE = (3, 8, 2, 32, 48)          # B, Hq, Hkv, D, S: a group of 4


def _swa_inputs(seed=31):
    b, hq, hkv, d, s = SWA_SHAPE
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    # a full ring, a wrapped one, a short one
    length = np.array([s, s // 2 + 3, 9], np.int32)
    start = np.array([0, s - 2, 5], np.int32)
    return q, k, v, length, start


def _three_ways(q, k, v, length, start):
    """(oracle, plain, the kernel's arithmetic) over the same inputs."""
    t = [torch.from_numpy(a) for a in (q, k, v, length, start)]
    oracle = np.asarray(jref.swa_decode_ref(*map(jnp.asarray,
                                                 (q, k, v, length, start))))
    plain = swa.swa_decode_plain(*t).numpy()
    s = k.shape[1]
    mirror = split_mirror(*t, 3, -(-s // 3)).numpy()
    return oracle, plain, mirror


def _group_rows(b, h):
    """(batch, head) rows of kv head ``h``'s group in batch row ``b``."""
    g = SWA_SHAPE[1] // SWA_SHAPE[2]
    return [(b, h * g + j) for j in range(g)]


def _assert_close_nan(got, exp):
    nan = np.isnan(exp)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], exp[~nan], rtol=swa.RTOL,
                               atol=swa.ATOL)


def test_swa_decode_nan_in_a_valid_k_row():
    q, k, v, length, start = _swa_inputs()
    k[0, 11, 1, 4] = np.nan                       # row 0: every slot valid
    k[1, (start[1] + 2) % k.shape[1], 0, 0] = np.nan
    oracle, plain, mirror = _three_ways(q, k, v, length, start)
    rows = _group_rows(0, 1) + _group_rows(1, 0)
    nan = np.zeros(oracle.shape[:2], bool)
    for r in rows:
        nan[r] = True
    assert np.array_equal(np.isnan(oracle).all(-1), nan)
    assert not (np.isnan(oracle).any(-1) & ~nan).any()
    _assert_close_nan(plain, oracle)
    _assert_close_nan(mirror, plain)


def test_swa_decode_nan_at_a_masked_slot():
    """K's NaN at a masked slot changes nothing anywhere; V's makes the
    reference and the plain version NaN for the group, where the kernel's
    arithmetic (valid slots only) stays finite: ROADMAP.md C.3."""
    q, k, v, length, start = _swa_inputs()
    s = k.shape[1]
    masked = (start[2] + length[2] + 4) % s          # row 2 holds 9 of 48
    k[2, masked, 0, 3] = np.nan
    oracle, plain, mirror = _three_ways(q, k, v, length, start)
    assert not np.isnan(oracle).any()
    _assert_close_nan(plain, oracle)
    _assert_close_nan(mirror, plain)

    v[2, masked, 1, 5] = np.nan
    oracle, plain, mirror = _three_ways(q, k, v, length, start)
    nan_rows = [r for r in _group_rows(2, 1)]
    for r in nan_rows:
        assert np.isnan(oracle[r][5]) and np.isnan(plain[r][5])
    assert np.array_equal(np.isnan(plain), np.isnan(oracle))
    assert np.isfinite(mirror).all()
    rest = ~np.isnan(oracle)
    np.testing.assert_allclose(mirror[rest], oracle[rest], rtol=swa.RTOL,
                               atol=swa.ATOL)
