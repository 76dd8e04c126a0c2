"""unorm8 frames, on the CPU: 8-bit unsigned-normalised pixels, the byte
v standing for ``v / 255``, served by ``FrameEngine(pixels="unorm8")``.

The decode table against the correctly rounded quotient; the engine on
every rung (a compiled batch with idle slots, the tiled rung, the
reference rung) bit for bit against the benchmark's plain reference
(``bench_port/reference/pipelines.py``) on the decoded frames; frames of
another type refused at admission; the float32 engine as it was; and
the bytes the hand-over says it moved, staged ahead and inline. The card
runs the decode kernel and the same engine in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from bench_port.harness import check
from bench_port.reference import pipelines as reference
from repro_torch.core import algorithms
from repro_torch.imaging import FrameEngine, FrameRequest
from repro_torch.imaging import hand_over as ho
from repro_torch.imaging.hand_over import hand_over
from repro_torch.kernels import stage_ahead, unorm8
from repro_torch.obs import trace
from repro_torch.resilience import (RejectedFrame, ResilienceConfig,
                                    RetryPolicy)
from repro_torch.resilience.chaos import ChaosMonkey, install_chaos

CARD = torch.device("cuda")          # a device object only: nothing runs
NAMES = sorted(algorithms.ALGORITHMS)


def _u8(seed, n, h, w):
    return list(np.random.default_rng(seed).integers(
        0, 256, (n, h, w), dtype=np.uint8))


def _want(name, frame):
    """The plain reference on the decode of ``frame``, written out."""
    v = torch.from_numpy(frame.astype(np.float32))
    return reference.run(name, (v / torch.tensor(255.0))[None])


# ---------------------------------------------------------------- decode
def test_the_table_is_the_correctly_rounded_quotient():
    v = np.arange(256)
    want = v.astype(np.float32) / np.float32(255)
    assert unorm8.TABLE.dtype == np.float32
    assert np.array_equal(unorm8.TABLE.view(np.int32), want.view(np.int32))
    # the quotient in float64, rounded once, is the same number
    assert np.array_equal(unorm8.TABLE, (v / 255.0).astype(np.float32))
    assert unorm8.TABLE[0] == 0.0 and unorm8.TABLE[255] == 1.0


@pytest.mark.parametrize("shape", [(256,), (3, 5, 7), (2, 9, 16)])
def test_the_plain_decode_indexes_the_table(shape):
    n = int(np.prod(shape))
    raw = torch.from_numpy((np.arange(n) * 37 % 256).astype(np.uint8)
                           .reshape(shape))
    out = unorm8.decode(raw)
    assert out.dtype == torch.float32 and out.shape == raw.shape
    assert torch.equal(out, torch.from_numpy(unorm8.TABLE[raw.numpy()]))
    into = torch.full(shape, float("nan"))
    assert unorm8.decode(raw, into) is into and torch.equal(into, out)
    assert unorm8.decode.launches == 0           # no kernel on the CPU


def test_the_decode_refuses_what_it_cannot_take():
    raw = torch.zeros((4, 6), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        unorm8.decode(raw.float())
    with pytest.raises(ValueError, match="float32 of shape"):
        unorm8.decode(raw, torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="float32 of shape"):
        unorm8.decode(raw, torch.zeros((4, 6), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        unorm8.decode(raw.t())
    assert unorm8.is_unorm8(raw) and unorm8.is_unorm8(raw.numpy())
    assert not unorm8.is_unorm8(raw.float())
    assert not unorm8.is_unorm8(raw.numpy().astype(np.int16))


# ---------------------------------------------------------------- engine
def _compiled(name, frames):
    """Three frames in a batch of four: one idle slot."""
    eng = FrameEngine(max_batch=4, tile_shape=frames[0].shape,
                      device="cpu", pixels="unorm8")
    for i, f in enumerate(frames):
        assert eng.submit(FrameRequest(rid=i, pipeline=name,
                                       frames={"in": f}))
    res = eng.step()
    assert len(res) == len(frames) and eng.pending == 0
    assert {r.rung for r in res} == {"default"}
    return [r.output for r in res]


def _tiled(name, frames):
    eng = FrameEngine(max_batch=4, tile_shape=(24, 32), device="cpu",
                      pixels="unorm8")
    res = eng.run([FrameRequest(rid=i, pipeline=name, frames={"in": f})
                   for i, f in enumerate(frames)])
    assert eng.metrics.fallback_frames == 0
    return [res[i] for i in range(len(frames))]


def _reference_rung(name, frames):
    eng = FrameEngine(max_batch=4, tile_shape=frames[0].shape, device="cpu",
                      pixels="unorm8", resilience=ResilienceConfig(
                          breaker_failures=1,
                          retry=RetryPolicy(max_attempts=2,
                                            base_delay_s=1e-4, seed=0)))
    install_chaos(eng.cache, ChaosMonkey(seed=0, compile=1.0))
    for i, f in enumerate(frames):
        assert eng.submit(FrameRequest(rid=i, pipeline=name,
                                       frames={"in": f})) is True
    res = eng.step()
    assert [r.rung for r in res] == ["reference"] * len(frames)
    return [r.output for r in res]


RUNGS = {"compiled": (_compiled, (3, 23, 37)),
         "tiled": (_tiled, (2, 40, 56)),
         "reference": (_reference_rung, (2, 23, 37))}


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("name", NAMES)
def test_every_rung_serves_the_decoded_frame(name, rung):
    serve, (n, h, w) = RUNGS[rung]
    frames = _u8(3 * NAMES.index(name) + sorted(RUNGS).index(rung), n, h, w)
    frames[0][:2, :3] = [[0, 255, 128], [1, 254, 127]]
    outs = serve(name, frames)
    for f, out in zip(frames, outs):
        assert out.dtype == torch.float32
        assert check.ulp_gap(out, _want(name, f)) == 0


def test_a_float32_engine_serves_what_it_served_before():
    """The default engine takes any numeric frame as ``float32(v)``: a
    uint8 frame reads 0..255, not its decode."""
    eng = FrameEngine(max_batch=4, tile_shape=(23, 37), device="cpu")
    assert eng.pixels == "float32"
    u8 = _u8(5, 1, 23, 37)[0]
    f32 = np.random.default_rng(6).random((23, 37), dtype=np.float32)
    res = eng.run([FrameRequest(rid=0, pipeline="unsharp-m",
                                frames={"in": u8}),
                   FrameRequest(rid=1, pipeline="unsharp-m",
                                frames={"in": f32})])
    for i, f in enumerate((u8, f32)):
        want = reference.run("unsharp-m",
                             torch.from_numpy(f.astype(np.float32))[None])
        assert check.ulp_gap(res[i], want) == 0


def test_an_unknown_pixel_format_is_refused():
    with pytest.raises(ValueError, match="pixels"):
        FrameEngine(device="cpu", pixels="unorm16")


FLOATS = {"float32": lambda f: f.astype(np.float32),
          "float64": lambda f: f.astype(np.float64),
          "int16": lambda f: f.astype(np.int16),
          "tensor-float32": lambda f: torch.from_numpy(f.astype(np.float32))}


@pytest.mark.parametrize("kind", sorted(FLOATS))
@pytest.mark.parametrize("mode", ["strict", "resilient"])
def test_a_frame_of_another_type_is_refused_at_admission(mode, kind):
    frame = FLOATS[kind](_u8(7, 1, 12, 20)[0])
    eng = FrameEngine(device="cpu", pixels="unorm8",
                      resilience=ResilienceConfig() if mode == "resilient"
                      else None)
    req = FrameRequest(rid=3, pipeline="harris-m", frames={"in": frame})
    if mode == "strict":
        with pytest.raises(ValueError, match="uint8"):
            eng.submit(req)
    else:
        rej = eng.submit(req)
        assert isinstance(rej, RejectedFrame)
        assert rej.reason == "bad_dtype" and rej.rid == 3
        assert "uint8" in rej.detail
    assert eng.pending == 0 and eng.step() == []
    # a uint8 frame of the same request is admitted
    assert eng.submit(FrameRequest(rid=4, pipeline="harris-m",
                                   frames={"in": _u8(7, 1, 12, 20)[0]}))


# ------------------------------------------------------------- hand-over
@pytest.fixture(params=["ahead", "inline"])
def fake_card(request, monkeypatch):
    """Hand-overs to ``CARD`` on the CPU, every frame staged ahead by a
    ``FakeStager`` (``tests/test_torch_stage_ahead.py``) or none, the
    claims' buffers poisoned (NaN, or 0xA5 for bytes). Yields the way's
    name, a hand-over by it (``hand_over``'s arguments) and the buffers
    made."""
    from test_torch_stage_ahead import FakeStager
    made = []
    empty, stacked = torch.empty, ho._stacked

    def poisoned(*shape, dtype=None, device=None, **kw):
        t = empty(*shape, dtype=dtype, **kw)
        made.append(t.fill_(float("nan") if t.is_floating_point() else 0xA5))
        return t
    monkeypatch.setattr(torch, "empty", poisoned)
    monkeypatch.setattr(ho, "_stacked",
                        lambda fs, slots, device, dtype=torch.float32:
                        stacked(fs, slots, torch.device("cpu"), dtype))

    def over(frames, slots, device, pixels="float32", **attrs):
        if request.param == "inline":
            return hand_over(frames, slots, device, pixels, **attrs)
        dtype = torch.uint8 if pixels == "unorm8" else torch.float32
        st = FakeStager(device, slots * len(frames),
                        np.size(next(iter(frames.values()))[0])
                        * dtype.itemsize)
        tickets = {n: [st.put(f, stage_ahead.layout(f, dtype)) for f in fs]
                   for n, fs in frames.items()}
        out = hand_over(frames, slots, device, pixels, (st, tickets),
                        **attrs)
        assert st.claims == [[stage_ahead.AHEAD] * st.out]
        return out
    yield request.param, over, made


@pytest.mark.parametrize("pixels", ["unorm8", "float32"])
def test_the_spans_count_the_bytes_that_cross(fake_card, pixels):
    """``h2d_bytes``: one byte a unorm8 pixel, four a float32 one;
    ``pinned_bytes`` and ``ahead_bytes`` the same staged ahead, 0 inline;
    the decode under ``engine.unorm8``, inside ``engine.assemble``."""
    path, over, made = fake_card
    h, w = 5, 7
    frames = _u8(11, 3, h, w)
    if pixels == "float32":
        frames = [f.astype(np.float32) / 255 for f in frames]
    trace.clear()
    trace.enable()
    try:
        got = over({"in": frames}, 4, CARD, pixels, pipeline="p")["in"]
        events = trace.events()
    finally:
        trace.disable()
        trace.clear()
    decoded = [unorm8.TABLE[f] if pixels == "unorm8" else f for f in frames]
    want = torch.from_numpy(np.stack(decoded + [np.zeros((h, w),
                                                         np.float32)]))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    itemsize = 1 if pixels == "unorm8" else 4
    (asm,) = [e for e in events if e.name == "engine.assemble"]
    assert asm.attrs["h2d_bytes"] == itemsize * 3 * h * w
    assert asm.attrs["pinned_bytes"] == asm.attrs["ahead_bytes"] == \
        (itemsize * 3 * h * w if path == "ahead" else 0)
    # the claim's buffer, then the decode's
    assert len(made) == (path == "ahead") + (pixels == "unorm8")
    decodes = [e for e in events if e.name == "engine.unorm8"]
    if pixels == "float32":
        assert decodes == []
        return
    (dec,) = decodes
    assert dec.parent == "engine.assemble"
    assert dec.attrs == {"pipeline": "p", "n_frames": 3, "pixels": 3 * h * w}
    if path == "ahead":                  # the bytes, the idle slot zero
        raw = made[0]
        assert raw.dtype == torch.uint8 and raw.shape == (4, h, w)
        assert torch.equal(raw[:3], torch.from_numpy(np.stack(frames)))
        assert not raw[3].any()


def test_a_lone_unorm8_frame_and_a_full_batch(fake_card):
    _, over, _ = fake_card
    for n, slots in ((1, 1), (4, 4), (2, 5)):
        frames = _u8(12 + n, n, 9, 11)
        got = over({"a": frames, "b": frames[::-1]}, slots, CARD, "unorm8")
        for name, fs in (("a", frames), ("b", frames[::-1])):
            assert torch.equal(got[name][:n], torch.from_numpy(
                unorm8.TABLE[np.stack(fs)]))
            assert not got[name][n:].any()


def test_a_unorm8_hand_over_refuses_more_frames_than_slots():
    with pytest.raises(ValueError, match="exceeds"):
        hand_over({"in": _u8(0, 3, 4, 4)}, 2, torch.device("cpu"), "unorm8")
