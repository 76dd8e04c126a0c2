"""Kernel: the video state roll's share of its bytes roofline, %.

A roll rewrites a stream's frame rings: once they are full, each of the
d - 1 frames of a pipeline of history depth d (the reference's
``DEPTH``) is read once and written once, as float32
(:func:`bytes_moved`). The bound moves that for each of the program's
``executor.roll`` spans, by the span's pipeline, at the card's published
memory rate. The time is the union of the device kernels launched
inside those spans, whatever their names."""
from bench_port.harness import profile
from bench_port.reference import pipelines as reference

BYTES_PER_PIXEL = 4                  # the rings hold float32 frames


def bytes_moved(ring_frames: int, frame_pixels: int) -> int:
    """Bytes a roll of rings of ``ring_frames`` frames of
    ``frame_pixels`` pixels each has to move."""
    return 2 * ring_frames * frame_pixels * BYTES_PER_PIXEL


def read(ctx):
    if ctx.trace is None:
        return None
    # frame_bytes is one float32 input frame and one output frame
    pixels = ctx.frame_bytes // (2 * 4)
    moved = sum(bytes_moved(reference.DEPTH[e.attrs["pipeline"]] - 1, pixels)
                for e in ctx.spans if e.name == "executor.roll"
                and e.attrs.get("pipeline") in reference.DEPTH)
    ks = profile.kernels_launched_in(ctx.trace, "executor.roll")
    busy = sum(t - s for s, t in profile.union((k[1], k[2]) for k in ks))
    if not moved or not busy:
        return None
    bound_ns = moved / ctx.peak_bytes_per_s * 1e9
    return 100.0 * bound_ns / busy
