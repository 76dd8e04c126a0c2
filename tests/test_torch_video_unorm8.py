"""unorm8 video, on the CPU: 8-bit unsigned-normalised frames, the byte v
standing for ``v / 255``, served by ``VideoEngine(pixels="unorm8")``.

Each of the four temporal pipelines on interleaved streams, by the chunk
path and the one-frame path, bit for bit against the benchmark's plain
reference (``bench_port/reference/pipelines.py``) over the decoded
frames, and against the float32 engine fed the decoded frames; a
resilient stream served off the reference rung and resumed on the
compiled one; frames of another type refused at admission; the bytes
the spans say crossed, one a pixel; the decode under ``engine.unorm8``;
the bfloat16 control off by far more than rounding; and the bytes the
state roll says it moved. The card serves 4K streams in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from bench_port.harness import check
from bench_port.reference import pipelines as reference
from repro_torch.core import algorithms
from repro_torch.imaging import PlanCache
from repro_torch.kernels import unorm8
from repro_torch.obs import trace
from repro_torch.resilience import (RejectedFrame, ResilienceConfig,
                                    RetryPolicy)
from repro_torch.resilience.chaos import ChaosMonkey, install_chaos
from repro_torch.video import CompletedVideoFrame, VideoEngine, VideoFrame

NAMES = sorted(algorithms.VIDEO_ALGORITHMS)
H, W = 72, 128
T = 10                                 # frames a stream


def _u8(seed, n, h=H, w=W):
    return list(np.random.default_rng(seed).integers(
        0, 256, (n, h, w), dtype=np.uint8))


def _want(name, frames, t, dtype=torch.float32):
    """The plain reference's output of frame t of a stream of uint8
    ``frames``, on their decode written out."""
    v = torch.from_numpy(np.stack(frames[:t + 1]).astype(np.float32))
    return reference.run(name, v / torch.tensor(255.0), dtype=dtype)


def _serve(eng, name, videos, chunk):
    """Interleaved streams of ``name``, one a video, each offering its
    frames ``chunk`` at a time; every stream's outputs in order."""
    sids = [eng.open_stream(name, H, W) for _ in videos]
    outs = {sid: [] for sid in sids}
    for t in range(0, T, chunk):
        for sid, vid in zip(sids, videos):
            for f in vid[t:t + chunk]:
                assert eng.submit(VideoFrame(sid, {"in": f})) is True
        while eng.pending:
            for c in eng.step():
                assert isinstance(c, CompletedVideoFrame), c
                outs[c.stream].append(c)
    for sid in sids:
        assert [c.index for c in outs[sid]] == list(range(T))
        eng.close_stream(sid)
    return [[c.output for c in outs[sid]] for sid in sids]


def _traced(fn):
    trace.clear()
    trace.enable()
    try:
        out = fn()
        return out, trace.events()
    finally:
        trace.disable()
        trace.clear()


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("path", ["chunk", "frame"])
@pytest.mark.parametrize("name", NAMES)
def test_streams_serve_the_decoded_frames(name, path):
    """Two interleaved streams, chunks of 4 (the last two frames of each
    alone) or one frame a call: every output bit for bit the reference's
    over the stream's decoded frames."""
    chunk = 4 if path == "chunk" else 1
    videos = [_u8(10 * NAMES.index(name) + i, T) for i in range(2)]
    videos[0][0][:2, :3] = [[0, 255, 128], [1, 254, 127]]
    eng = VideoEngine(chunk=chunk, device="cpu", pixels="unorm8")
    assert eng.pixels == "unorm8"
    got, events = _traced(lambda: _serve(eng, name, videos, chunk))
    for vid, outs in zip(videos, got):
        for t, out in enumerate(outs):
            assert out.dtype == torch.float32 and out.shape == (H, W)
            assert check.ulp_gap(out, _want(name, vid, t)) == 0, (name, t)
    calls = [e.attrs["chunk"] for e in events if e.name == "executor.call"]
    if path == "chunk":                 # 2 chunks and 2 frames a stream
        assert sorted(calls, key=str) == [4] * 4 + [None] * 4
    else:
        assert calls == [None] * 2 * T


@pytest.mark.parametrize("chunk", [1, 4])
def test_the_float32_engine_fed_the_decode_gives_the_same_bits(chunk):
    """The same streams as float32 frames ``v / 255`` through the default
    engine: equal tensors; and the default engine still reads a uint8
    frame as ``float32(v)``."""
    name = "tunsharp-t"
    videos = [_u8(40 + i, T) for i in range(2)]
    u8 = _serve(VideoEngine(chunk=chunk, device="cpu", pixels="unorm8"),
                name, videos, chunk)
    f32 = VideoEngine(chunk=chunk, device="cpu")
    assert f32.pixels == "float32"
    decoded = [[unorm8.TABLE[f] for f in vid] for vid in videos]
    for a, b in zip(u8, _serve(f32, name, decoded, chunk)):
        assert torch.equal(torch.stack(a), torch.stack(b))
    raw = _serve(VideoEngine(chunk=chunk, device="cpu"), name, videos,
                 chunk)
    v = torch.from_numpy(np.stack(videos[0]).astype(np.float32))
    assert check.ulp_gap(raw[0][-1], reference.run(name, v)) == 0


def test_an_unknown_pixel_format_is_refused():
    with pytest.raises(ValueError, match="pixels"):
        VideoEngine(device="cpu", pixels="unorm16")


FLOATS = {"float32": lambda f: f.astype(np.float32),
          "float64": lambda f: f.astype(np.float64),
          "int16": lambda f: f.astype(np.int16),
          "tensor-float32": lambda f: torch.from_numpy(f.astype(np.float32))}


@pytest.mark.parametrize("kind", sorted(FLOATS))
@pytest.mark.parametrize("mode", ["strict", "resilient"])
def test_a_frame_of_another_type_is_refused_at_admission(mode, kind):
    eng = VideoEngine(device="cpu", pixels="unorm8",
                      resilience=ResilienceConfig() if mode == "resilient"
                      else None)
    sid = eng.open_stream("tmotion-t", 12, 20)
    frame = FLOATS[kind](_u8(7, 1, 12, 20)[0])
    f = VideoFrame(sid, {"in": frame}, rid=3)
    if mode == "strict":
        with pytest.raises(ValueError, match="uint8"):
            eng.submit(f)
    else:
        rej = eng.submit(f)
        assert isinstance(rej, RejectedFrame) and not rej
        assert rej.reason == "bad_dtype" and rej.rid == 3
        assert rej.stream == sid and "uint8" in rej.detail
    assert eng.pending == 0 and eng.step() == []
    # a uint8 frame of the same stream is admitted
    assert eng.submit(VideoFrame(sid, {"in": _u8(7, 1, 12, 20)[0]})) is True


# ---------------------------------------------------------------- spans
@pytest.mark.parametrize("chunk", [1, 4])
def test_a_byte_a_pixel_crosses_and_the_card_decodes(chunk):
    """``h2d_bytes`` of ``engine.assemble``: one byte a pixel; one
    ``engine.unorm8`` span inside each, with its frames and pixels; the
    executor is handed device tensors, which cross nothing."""
    h, w = 16, 24
    eng = VideoEngine(chunk=chunk, device="cpu", pixels="unorm8")
    sid = eng.open_stream("tdenoise-t", h, w)
    frames = _u8(9, 8, h, w)

    def run():
        for f in frames:
            assert eng.submit(VideoFrame(sid, {"in": f}))
        while eng.pending:
            eng.step()
    _, events = _traced(run)
    asm = [e for e in events if e.name == "engine.assemble"]
    dec = [e for e in events if e.name == "engine.unorm8"]
    assert len(asm) == len(dec) == 8 // chunk
    assert [e.attrs["h2d_bytes"] for e in asm] == [chunk * h * w] * len(asm)
    assert all(e.parent == "engine.assemble" for e in dec)
    assert [e.attrs for e in dec] == [{"n_frames": chunk,
                                       "pixels": chunk * h * w,
                                       "pipeline": "tdenoise-t"}] * len(dec)
    calls = [e for e in events if e.name == "executor.call"]
    assert len(calls) == len(asm)
    assert not any("h2d_bytes" in e.attrs for e in calls)


@pytest.mark.parametrize("chunk", [1, 4])
def test_the_roll_counts_the_bytes_it_moves(chunk):
    """``roll_bytes`` of ``executor.roll``: every frame of the new rings
    written once and read once, 4 B a pixel, from the first call on."""
    h, w = 16, 24
    for name in NAMES:
        eng = VideoEngine(chunk=chunk, device="cpu", pixels="unorm8")
        sid = eng.open_stream(name, h, w)

        def run():
            for f in _u8(3, 8, h, w):
                assert eng.submit(VideoFrame(sid, {"in": f}))
            while eng.pending:
                eng.step()
        _, events = _traced(run)
        rolls = [e for e in events if e.name == "executor.roll"]
        assert len(rolls) == 8 // chunk
        depth = reference.history_depth(name)
        want = 2 * (depth - 1) * h * w * 4
        assert [e.attrs["roll_bytes"] for e in rolls] == \
            [want] * len(rolls), name
        ex = eng.cache.video_executor_for(name, h, w,
                                          chunk=None if chunk == 1 else chunk,
                                          rows_per_step=8)
        assert ex.state_roll_bytes == want


# ------------------------------------------------------------ resilience
@pytest.mark.parametrize("pipeline,chunk", [
    ("tmotion-t", 1), ("tbackground-t", 4), ("tdenoise-t", 2)])
def test_a_stream_resumed_from_the_reference_rung_is_exact(pipeline, chunk):
    """Frames served off the reference rung mid-stream, then the compiled
    rung again from the rebuilt rings: every output the reference's over
    the decoded frames, and the strict engine's bits."""
    retry = RetryPolicy(max_attempts=2, base_delay_s=1e-4, seed=0)
    eng = VideoEngine(chunk=chunk, device="cpu", pixels="unorm8",
                      cache=PlanCache(device="cpu", retry=retry),
                      resilience=ResilienceConfig(
                          retry=retry, breaker_failures=1,
                          breaker_reset_s=0.0))
    monkey = ChaosMonkey(seed=0)
    install_chaos(eng.cache, monkey)
    sid = eng.open_stream(pipeline, H, W)
    frames = _u8(60 + chunk, 6 * chunk)
    outs, rungs = [], []
    for t in range(0, len(frames), chunk):
        if t == 2 * chunk:          # blackout: compiled rungs broken
            monkey.rates["compile"] = 1.0
            eng.cache.evict_executors()
        elif t == 4 * chunk:        # recovery
            monkey.rates["compile"] = 0.0
        for k in range(chunk):
            assert eng.submit(VideoFrame(sid, {"in": frames[t + k]},
                                         rid=t + k)) is True
        comp = [c for c in eng.step()
                if isinstance(c, CompletedVideoFrame)]
        assert [c.rid for c in comp] == list(range(t, t + chunk))
        outs += [c.output for c in comp]
        rungs += [c.rung for c in comp]
    c2 = 2 * chunk
    assert rungs == ["default"] * c2 + ["reference"] * c2 \
        + ["default"] * c2
    hist = eng._sessions[sid].history["in"]
    assert all(x.dtype == np.float32 for x in hist)
    assert np.array_equal(hist[-1], unorm8.TABLE[frames[-1]])
    for t, out in enumerate(outs):
        assert check.ulp_gap(out, _want(pipeline, frames, t)) == 0, t
    strict = VideoEngine(chunk=chunk, device="cpu", pixels="unorm8")
    sid2 = strict.open_stream(pipeline, H, W)
    got = strict.run({sid2: [{"in": f} for f in frames]})[sid2]
    assert torch.equal(torch.stack(outs), torch.stack(got))
    assert eng.metrics.fallback_frames == c2


# --------------------------------------------------------------- control
@pytest.mark.parametrize("name", NAMES)
def test_the_bfloat16_control_fails_the_comparison(name):
    """The reference in ``CONTROL_DTYPE`` over the same decoded frames is
    off by far more than the check's limit of 0 ulp."""
    vid = _u8(80 + NAMES.index(name), T)
    (outs,) = _serve(VideoEngine(chunk=4, device="cpu", pixels="unorm8"),
                     name, [vid], 4)
    gaps = [check.ulp_gap(outs[t], _want(name, vid, t,
                                         reference.CONTROL_DTYPE))
            for t in range(T)]
    assert max(gaps) > 2 ** 16, gaps
