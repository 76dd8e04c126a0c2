"""The port's standalone kernels (conv2d, swa_decode) against the JAX oracles.

The same inputs, made with numpy from a seed, go through the JAX
package's pure-jnp oracles (``repro.kernels.ref``) and the port's entry
points (``repro_torch.kernels.ops``) on the CPU, where the wrappers run
their kernels' plain PyTorch versions. Tolerances are the JAX package's
own for these kernels (``tests/test_kernels.py``): conv2d rtol = atol =
1e-5; swa_decode rtol 2e-4, atol 2e-5, and 2e-2 for bf16 inputs. The
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) and, for conv2d, as
host C++ (``tests/test_torch_kernel_host.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import conv2d_stencil, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swa_decode as swa

RNG = np.random.RandomState(42)
SWA_SHAPES = [
    # B, Hq, Hkv, D, S
    (1, 4, 4, 32, 16),     # MHA
    (2, 8, 2, 64, 32),     # GQA
    (3, 8, 1, 16, 64),     # MQA
]


@pytest.mark.parametrize("hw", [(8, 16), (20, 24), (13, 130), (9, 257)])
@pytest.mark.parametrize("k", [(1, 1), (3, 3), (1, 5), (5, 1), (2, 4)])
def test_conv2d_matches_jax_oracle(hw, k):
    h, w = hw
    img = RNG.rand(h, w).astype(np.float32)
    wts = RNG.randn(*k).astype(np.float32)
    before = conv2d_stencil.conv2d.launches
    got = ops.conv2d(img, wts, device="cpu")
    exp = jref.conv2d_ref(jnp.asarray(img), jnp.asarray(wts))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=1e-5, atol=1e-5)
    assert conv2d_stencil.conv2d.launches == before   # plain version
    assert torch.equal(tref.conv2d_ref(torch.from_numpy(img),
                                       torch.from_numpy(wts)), got)


@pytest.mark.parametrize("tile_rows", [1, 8, 64])
def test_conv2d_tile_rows_do_not_change_the_result(tile_rows):
    img = torch.from_numpy(RNG.rand(21, 40).astype(np.float32))
    wts = torch.from_numpy(RNG.randn(3, 3).astype(np.float32))
    assert torch.equal(conv2d_stencil.conv2d(img, wts, tile_rows=tile_rows),
                       conv2d_stencil.conv2d_plain(img, wts))


def test_conv2d_casts_and_rejects():
    img = RNG.rand(6, 9)                          # float64, as numpy makes
    wts = RNG.randn(2, 2)
    got = ops.conv2d(img, wts, device="cpu")
    exp = conv2d_stencil.conv2d_plain(torch.from_numpy(img).float(),
                                      torch.from_numpy(wts).float())
    assert got.dtype == torch.float32 and torch.equal(got, exp)
    with pytest.raises(ValueError, match="image"):
        conv2d_stencil.conv2d(torch.zeros(2, 3, 4), torch.ones(1, 1))
    with pytest.raises(ValueError, match="tile_rows"):
        conv2d_stencil.conv2d(torch.zeros(3, 4), torch.ones(1, 1),
                              tile_rows=0)
    assert conv2d_stencil.smem_bytes(5, 5, 8) < conv2d_stencil.SMEM_LIMIT


def _swa_inputs(shape, rng, dtype=np.float32):
    b, hq, hkv, d, s = shape
    q = rng.randn(b, hq, d).astype(dtype)
    k = rng.randn(b, s, hkv, d).astype(dtype)
    v = rng.randn(b, s, hkv, d).astype(dtype)
    length = rng.randint(1, s + 1, size=(b,)).astype(np.int32)
    start = rng.randint(0, s, size=(b,)).astype(np.int32)
    return q, k, v, length, start


@pytest.mark.parametrize("shape", SWA_SHAPES)
def test_swa_decode_matches_jax_oracle(shape):
    args = _swa_inputs(shape, RNG)
    before = swa.swa_decode.launches
    got = ops.swa_decode(*args, device="cpu")
    exp = jref.swa_decode_ref(*map(jnp.asarray, args))
    assert got.shape == shape[:2] + (shape[3],)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=swa.RTOL, atol=swa.ATOL)
    assert swa.swa_decode.launches == before          # plain version
    # the port's oracle is the JAX one in torch
    np.testing.assert_allclose(
        tref.swa_decode_ref(*map(torch.from_numpy, args)).numpy(),
        np.asarray(exp), rtol=swa.RTOL, atol=swa.ATOL)


def test_swa_decode_bf16_inputs():
    b, hq, hkv, d, s = 2, 4, 2, 32, 16
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(*sh).astype(np.float32))
               .to(torch.bfloat16)
               for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    length = torch.full((b,), s, dtype=torch.int32)
    start = torch.zeros((b,), dtype=torch.int32)
    got = ops.swa_decode(q, k, v, length, start, device="cpu")
    assert got.dtype == torch.float32
    exp = jref.swa_decode_ref(*(jnp.asarray(t.float().numpy())
                                for t in (q, k, v, length, start)))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", SWA_SHAPES + [(2, 4, 1, 256, 512)])
def test_swa_decode_empty_and_wrapped_rings(shape):
    """length = 0 gives zeros (not the oracle's NaN), a full window
    (length = S) and a ring_start that wraps the valid range past slot
    S - 1 match the oracle, and length > S reads as a full ring."""
    b, hq, hkv, d, s = shape
    q, k, v, _, _ = _swa_inputs(shape, np.random.RandomState(8))
    for length, start in [(0, 3), (s, s - 1), (s // 2 + 1, s - 2),
                          (s + 5, 1)]:
        ln = np.full((b,), length, np.int32)
        st = np.full((b,), start, np.int32)
        got = ops.swa_decode(q, k, v, ln, st, device="cpu")
        if length == 0:
            assert torch.equal(got, torch.zeros_like(got))
            continue
        exp = jref.swa_decode_ref(*map(jnp.asarray, (q, k, v, ln, st)))
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   rtol=swa.RTOL, atol=swa.ATOL)


def test_swa_decode_mixed_rows_and_scalars():
    """Per-row length and ring_start: an empty row beside full and
    wrapped ones; scalars broadcast over the batch."""
    shape = (3, 8, 2, 64, 32)
    q, k, v, _, _ = _swa_inputs(shape, np.random.RandomState(9))
    ln = np.array([0, 32, 7], np.int32)
    st = np.array([5, 0, 29], np.int32)
    got = ops.swa_decode(q, k, v, ln, st, device="cpu")
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    exp = jref.swa_decode_ref(*map(jnp.asarray, (q, k, v, ln, st)))
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(exp)[1:],
                               rtol=swa.RTOL, atol=swa.ATOL)
    one = ops.swa_decode(q, k, v, 7, 29, device="cpu")
    full = ops.swa_decode(q, k, v, np.full(3, 7, np.int32),
                          np.full(3, 29, np.int32), device="cpu")
    assert torch.equal(one, full)


def test_swa_decode_rejects_bad_shapes():
    q = torch.zeros(2, 6, 16)
    k = torch.zeros(2, 8, 4, 16)
    with pytest.raises(ValueError, match="multiple"):
        swa.swa_decode(q, k, k, 8, 0)
    with pytest.raises(ValueError, match="takes"):
        swa.swa_decode(q[0], k, k, 8, 0)
    # the split kernel stays under the 48 KB a CTA takes without raising
    # its shared-memory attribute, at any window
    assert swa.smem_bytes(4, 256) <= 48 * 1024


def test_standalone_entry_points_refuse_to_run_without_a_card():
    img, wts = RNG.rand(4, 8), RNG.rand(2, 2)
    if torch.cuda.is_available():
        assert ops.conv2d(img, wts).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.conv2d(img, wts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.swa_decode(*_swa_inputs(SWA_SHAPES[0], RNG))
