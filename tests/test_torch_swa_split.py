"""Rehearsal of the swa_decode kernel's split and combine arithmetic on the CPU.

The CUDA kernel (``csrc/swa_decode.cu``) runs only on a card, and its warp
shuffles do not compile under the host shim. Its arithmetic does not need
them: :func:`split_mirror` repeats it in torch — the ring positions in
``splits`` runs of ``chunk``, each split's warps taking blocks of
positions in turn with an online softmax (running max, sum and
accumulator), the warps merged per split, the splits combined with
M = max_s m_s (0 when every split is empty). The same inputs, made with
numpy from a seed, go through the mirror, ``swa_decode_plain`` and the
JAX package's oracle ``repro.kernels.ref.swa_decode_ref``, held at the
kernel's tolerance (``swa_decode.RTOL`` / ``ATOL``). The oracle gives NaN
for a row with no valid slot, where the kernel gives zeros: such rows
are checked for exact zeros instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import swa_decode as swa


def _merge(parts):
    """(m, l, acc) of several partials over the same rows, combined as
    the kernels combine them: m stays -inf where every part is empty."""
    ms = torch.stack([p[0] for p in parts])               # (n, g)
    mx = ms.amax(0)
    m0 = torch.where(mx == -torch.inf, torch.zeros_like(mx), mx)
    c = torch.exp(ms - m0)                                 # 0 for empty
    lsum = (torch.stack([p[1] for p in parts]) * c).sum(0)
    acc = (torch.stack([p[2] for p in parts]) * c[..., None]).sum(0)
    return mx, lsum, acc


def split_mirror(q, k, v, length, ring_start, splits, chunk):
    """The kernel's split, online-softmax, warp-merge and combine
    arithmetic in torch, float32: q (B, Hq, D), k, v (B, S, Hkv, D)."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g, u = hq // hkv, swa.round_slots(d)
    scale = 1.0 / float(d) ** 0.5
    out = torch.empty(b, hq, d)
    for bi in range(b):
        n = min(max(int(length[bi]), 0), s)
        start = int(ring_start[bi]) % s
        for h in range(hkv):
            qg = q[bi, h * g:(h + 1) * g]
            kh, vh = k[bi, :, h], v[bi, :, h]
            per_split = []
            for sp in range(splits):
                lo, hi = sp * chunk, min(sp * chunk + chunk, n)
                per_warp = []
                for w in range(swa.WARPS):
                    m = torch.full((g,), -torch.inf)
                    lsum, acc = torch.zeros(g), torch.zeros(g, d)
                    for p0 in range(lo + w * u, hi, swa.WARPS * u):
                        slots = (start + torch.arange(p0, min(p0 + u, hi))) % s
                        sc = (qg @ kh[slots].T) * scale            # (g, u)
                        mn = torch.maximum(m, sc.amax(1))          # finite
                        alpha = torch.exp(m - mn)
                        p = torch.exp(sc - mn[:, None])
                        lsum = lsum * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ vh[slots]
                        m = mn
                    per_warp.append((m, lsum, acc))
                per_split.append(_merge(per_warp))
            _, lsum, acc = _merge(per_split)
            out[bi, h * g:(h + 1) * g] = acc / lsum.clamp_min(1e-30)[:, None]
    return out


def _inputs(shape, seed):
    b, hq, hkv, d, s = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32))


def _check(shape, length, start, splits, seed=0):
    b, hq, hkv, d, s = shape
    q, k, v = _inputs(shape, seed)
    length = np.asarray(length, np.int32)
    start = np.asarray(start, np.int32)
    chunk = -(-s // splits)
    got = split_mirror(*map(torch.from_numpy, (q, k, v, length, start)),
                       -(-s // chunk), chunk)
    assert torch.isfinite(got).all()
    plain = swa.swa_decode_plain(*map(torch.from_numpy,
                                      (q, k, v, length, start)))
    torch.testing.assert_close(got, plain, rtol=swa.RTOL, atol=swa.ATOL)
    empty = length <= 0
    assert torch.equal(got[torch.from_numpy(empty)],
                       torch.zeros_like(got[torch.from_numpy(empty)]))
    if (~empty).any():
        exp = np.asarray(jref.swa_decode_ref(*map(jnp.asarray,
                                                  (q, k, v, length, start))))
        np.testing.assert_allclose(got[torch.from_numpy(~empty)].numpy(),
                                   exp[~empty], rtol=swa.RTOL,
                                   atol=swa.ATOL)


SHAPES = [
    # B, Hq, Hkv, D, S
    (3, 8, 2, 64, 32),     # GQA
    (3, 8, 1, 16, 64),     # MQA
    (2, 6, 1, 32, 48),     # G = 6, as Mixtral-8x22b's local layers
]


@pytest.mark.parametrize("splits", [1, 2, 3, 8, "S"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_mirror_matches_plain_and_oracle(shape, splits):
    """A full window, a wrapped one, a short one and an empty row at
    every split count from one to one position per split."""
    s = shape[4]
    splits = s if splits == "S" else splits
    rng = np.random.RandomState(1)
    length = [s, s // 2 + 3, 0][:shape[0]]
    start = [rng.randint(s), s - 2, 5][:shape[0]]
    _check(shape, length, start, splits)


@pytest.mark.parametrize("length", [1, 5, 17])
def test_split_mirror_empty_splits(length):
    """Lengths that leave later splits empty (one slot, less than one
    split, a split and a bit): their partials are (-inf, 0, 0) and drop
    out of the combine."""
    shape = (2, 4, 1, 32, 64)
    _check(shape, [length, length], [0, 60], splits=8)


def test_split_mirror_all_rows_empty():
    """Every split of every row empty: zeros, not NaN."""
    shape = (2, 4, 2, 32, 64)
    _check(shape, [0, -3], [7, 0], splits=8)


@pytest.mark.parametrize("start", [13, 14, 15])
def test_split_mirror_wrap_at_and_inside_a_split(start):
    """A ring whose wrap (slot S - 1 to slot 0) falls on a split
    boundary and inside a split, with a full and a partial window."""
    shape = (2, 8, 2, 32, 32)
    # chunk 8: ring_start r wraps at position 32 - r, so 13-15 wrap inside
    # split 2 (17-18 inside split 1), 16 and 24 on a split boundary
    _check(shape, [32, 27], [start, start + 3], splits=4)
    _check(shape, [32, 27], [16, 24], splits=4)


def test_split_plan_covers_the_ring():
    """The wrapper's split counts: every ring position in one split, at
    least MIN_CHUNK positions a split (or one split); the two model
    shapes the smoke test times."""
    for b, hkv, g, s, d in [(64, 1, 4, 512, 256), (8, 8, 6, 4096, 128),
                            (1, 4, 1, 16, 32), (3, 1, 8, 64, 16),
                            (1, 1, 1, 100_000, 128), (512, 8, 8, 4096, 128)]:
        splits, chunk = swa.split_plan(b, hkv, g, s, d, sms=132)
        assert 1 <= splits <= swa.MAX_SPLITS
        assert splits * chunk >= s > (splits - 1) * chunk
        assert splits == 1 or chunk >= swa.MIN_CHUNK
    assert swa.split_plan(64, 1, 4, 512, 256, 132) == (4, 128)     # gemma3
    assert swa.split_plan(8, 8, 6, 4096, 128, 132) == (16, 256)    # mixtral


def test_shared_memory_does_not_grow_with_the_window():
    """Shared memory per CTA depends on G and D only; the refusal is for
    head dims a lane's registers cannot hold."""
    # rings of 3 rounds of 2 (D=256) and 4 (D=128) positions, K and V
    assert swa.smem_bytes(4, 256) == swa.WARPS * 3 * 2 * 2 * 256 * 4
    assert swa.smem_bytes(6, 128) == swa.WARPS * 3 * 2 * 4 * 128 * 4
    # the warps' merge where it outgrows the rings (a tiny head dim)
    assert swa.smem_bytes(8, 2) == swa.WARPS * 8 * (2 + 2) * 4
    assert swa.rows_per_pass(16, 128) == swa.MAX_ROWS
    assert swa.rows_per_pass(8, 512) == 4
    assert swa.rows_per_pass(4, 100) == 4 and swa.share(100) == 4
    assert swa.rows_per_pass(4, 513) == 0
    assert swa.rows_per_pass(4, 258) == 0
    assert swa.share(255) == 8
    assert max(swa.smem_bytes(g, d) for g in range(1, 17)
               for d in range(1, 513) if swa.share(d)) <= 48 * 1024
