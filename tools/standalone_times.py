"""Time the standalone kernels (conv2d, swa_decode) on the card, in turns.

    PYTHONPATH=src python3 tools/standalone_times.py [--old-csrc DIR] \
        [--sweep] [--iters 50]

Shapes: conv2d on a 1080p frame with a 3x3 and a 5x5 filter; swa_decode
at gemma3-1b's local layers (B=64, Hq=4, Hkv=1, D=256, window 512) and
at Mixtral-8x22b's sliding-window layer (B=8, Hq=48, Hkv=8, D=128,
window 4096), every ring full from a random start. For each shape and
version prints one JSON line per turn with the time per call
(``event_ms``: CUDA events around back-to-back calls) and the device
time per call (``device_ms``: every kernel the call launches, from the
profiler). Versions:

  * ``new`` — this tree's wrappers (``conv2d_stencil.conv2d``,
    ``swa_decode.swa_decode``);
  * ``library`` — one PyTorch call for the same function:
    ``F.conv2d`` with cuDNN's TF32 off, and
    ``scaled_dot_product_attention`` with a boolean ring mask and
    ``enable_gqa``;
  * ``old`` (with ``--old-csrc DIR``) — ``DIR/conv2d_stencil.cu`` and
    ``DIR/swa_decode.cu`` of the earlier design (one CTA per 8-row tile;
    one CTA per (batch, kv head)), built with the same nvcc flags into
    the build directory and called through their C interfaces as their
    wrappers called them: ``conv2d_launch(img, wts, out, h, w, kh, kw,
    tr, stream)`` and ``swa_decode_launch(q, k, v, length, ring_start,
    out, b, hkv, g, s, d, scale, stream)``.

Turns run old, new, library, library, new, old, so drift shows. Every
version's output is first held against the plain version (0 ULP for
conv2d; ``swa_decode.RTOL`` / ``ATOL``). ``--sweep`` adds the launch
geometry by device time: conv2d bands x output columns per thread, and
swa_decode split counts. The card's name and power limit come first.
Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, conv2d_stencil
from repro_torch.kernels import swa_decode as swa
from repro_torch.perf.measure import card_info
from repro_torch.perf.timing import device_ms, event_ms

H, W = 1080, 1920
CONV_FILTERS = [(3, 3), (5, 5)]
SWA_SHAPES = {"gemma3-1b": (64, 4, 1, 256, 512),       # B, Hq, Hkv, D, S
              "mixtral-8x22b": (8, 48, 8, 128, 4096)}
TURNS = ("old", "new", "library", "library", "new", "old")
BANDS, COLS = (4, 8, 16, 32, 64), (1, 2, 4)
SPLITS = (1, 2, 4, 8, 16, 32, 64)


def build_old(csrc: Path) -> dict[str, ctypes.CDLL]:
    """The two sources in ``csrc`` built in parallel, with their C
    interfaces bound."""
    procs = {}
    for name in ("conv2d_stencil", "swa_decode"):
        lib = _build.BUILD_DIR / f"libold-{name}.so"
        _build.BUILD_DIR.mkdir(exist_ok=True)
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"standalone_times: nvcc failed for "
                             f"{name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
    conv = libs["conv2d_stencil"].conv2d_launch
    conv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    dec = libs["swa_decode"].swa_decode_launch
    dec.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_void_p]
    conv.restype = dec.restype = ctypes.c_int
    return libs


def _old_conv(lib, img, wts):
    (h, w), (kh, kw) = img.shape, wts.shape
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        rc = lib.conv2d_launch(img.data_ptr(), wts.data_ptr(),
                               out.data_ptr(), h, w, kh, kw, 8,
                               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old conv2d launch failed: {rc}")
    return out


def _old_swa(lib, q, k, v, length, start):
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.swa_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            start.data_ptr(), out.data_ptr(), b, hkv, hq // hkv, s, d,
            1.0 / float(d) ** 0.5, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old swa_decode launch failed: {rc}")
    return out


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def _turns(kernel, shape, versions, iters, check, **extra) -> None:
    """Check every version, then time them in TURNS."""
    diff = {tag: check(tag, fn()) for tag, fn in versions.items()}
    for turn, tag in enumerate(TURNS):
        if tag not in versions:
            continue
        dev, by_name = device_ms(versions[tag], iters)
        _emit(kernel=kernel, shape=shape, version=tag, turn=turn,
              event_ms=event_ms(versions[tag], iters), device_ms=dev,
              device_ms_by_kernel=by_name, max_abs_diff=diff[tag], **extra)


def conv2d_times(dev, old, iters: int, sweep: bool) -> None:
    rng = np.random.RandomState(9)
    img = torch.from_numpy(rng.rand(H, W).astype(np.float32)).to(dev)
    for kh, kw in CONV_FILTERS:
        wts = torch.from_numpy(rng.randn(kh, kw).astype(np.float32)).to(dev)
        exp = conv2d_stencil.conv2d_plain(img, wts)
        padded = F.pad(img, (kw - 1, 0, kh - 1, 0))[None, None]
        versions = {
            "new": lambda: conv2d_stencil.conv2d(img, wts),
            "library": lambda: F.conv2d(padded, wts[None, None])[0, 0]}
        if old:
            versions["old"] = lambda: _old_conv(old["conv2d_stencil"], img,
                                                wts)

        def check(tag, got):
            if tag != "library" and not torch.equal(got, exp):
                raise SystemExit(f"conv2d {kh}x{kw} {tag}: differs from "
                                 f"the plain version")
            return (got - exp).abs().max().item()
        conv2d_stencil.conv2d(img, wts)
        _turns("conv2d", [H, W, kh, kw], versions, iters, check,
               variant=conv2d_stencil.conv2d.variant,
               band=8,
               cols=conv2d_stencil.COLS, bytes=2 * H * W * 4 + kh * kw * 4)
        if not sweep:
            continue
        for cols in COLS:
            for band in BANDS:
                def fn():
                    return conv2d_stencil.conv2d.launch(img, wts, band, cols)
                if not torch.equal(fn(), exp):
                    raise SystemExit(f"conv2d {kh}x{kw} band {band} cols "
                                     f"{cols}: differs from plain")
                _emit(kernel="conv2d", sweep=True, shape=[H, W, kh, kw],
                      band=band, cols=cols,
                      variant=conv2d_stencil.conv2d.variant,
                      device_ms=device_ms(fn, iters)[0],
                      event_ms=event_ms(fn, iters))


def swa_times(dev, old, iters: int, sweep: bool) -> None:
    rng = np.random.RandomState(10)
    for model, shape in SWA_SHAPES.items():
        b, hq, hkv, d, s = shape
        q, k, v = (torch.from_numpy(rng.randn(*sh).astype(np.float32))
                   .to(dev) for sh in ((b, hq, d), (b, s, hkv, d),
                                       (b, s, hkv, d)))
        length = torch.full((b,), s, dtype=torch.int32, device=dev)
        start = torch.from_numpy(rng.randint(0, s, size=b)
                                 .astype(np.int32)).to(dev)
        exp = swa.swa_decode_plain(q, k, v, length, start)
        mask = swa.ring_valid(length, start, s)[:, None, None, :]
        qs, ks, vs = (q[:, :, None], k.permute(0, 2, 1, 3),
                      v.permute(0, 2, 1, 3))
        versions = {
            "new": lambda: swa.swa_decode(q, k, v, length, start),
            "library": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0]}
        if old:
            versions["old"] = lambda: _old_swa(old["swa_decode"], q, k, v,
                                               length, start)

        def check(tag, got):
            err = (got - exp).abs().max().item()
            if tag != "library" and not (torch.isfinite(got).all() and
                                         torch.allclose(got, exp,
                                                        rtol=swa.RTOL,
                                                        atol=swa.ATOL)):
                raise SystemExit(f"swa_decode {model} {tag}: differs from "
                                 f"the plain version by {err}")
            return err
        swa.swa_decode(q, k, v, length, start)
        _turns("swa_decode", shape, versions, iters, check, model=model,
               splits=swa.swa_decode.splits,
               bytes=2 * b * s * hkv * d * 4 + 2 * b * hq * d * 4 + 8 * b)
        if not sweep:
            continue
        for want in SPLITS:
            chunk = -(-s // want)
            splits = -(-s // chunk)

            def fn():
                return swa.swa_decode.launch(q, k, v, length, start,
                                             splits, chunk)
            check(f"{splits} splits", fn())
            _emit(kernel="swa_decode", sweep=True, model=model, shape=shape,
                  splits=splits, chunk=chunk,
                  device_ms=device_ms(fn, iters)[0],
                  event_ms=event_ms(fn, iters))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, default=None,
                    help="directory with the earlier conv2d_stencil.cu "
                         "and swa_decode.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep bands, columns per thread and splits")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("standalone_times: no CUDA device")
    smi = card_info()["nvidia_smi"]
    _emit(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cudnn.allow_tf32 = False       # float32 yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build("conv2d_stencil", "swa_decode")
    old = build_old(args.old_csrc) if args.old_csrc else None
    dev = torch.device("cuda")
    conv2d_times(dev, old, args.iters, args.sweep)
    swa_times(dev, old, args.iters, args.sweep)


if __name__ == "__main__":
    main()
