"""The stager of :class:`~repro_torch.imaging.FrameEngine`: host frames
admitted ahead of their batch are copied to the card by threads that
never take Python's lock, so the copy leaves the serving thread's step.

A :class:`Stager` owns a ring of slots, each one frame's bytes, in
page-locked memory and on the card, and the threads of the stager in
the shared library of ``csrc/stencil_pipeline.cu`` (host C++, between
its ``stage ahead`` markers), which serving loads anyway. :meth:`put`
queues a frame and returns its ticket; a lead thread takes tickets in
the order they were put, one whenever a slot is free, and a team of
:func:`copy_threads` threads copies each frame into its slot's
page-locked half in chunks (streaming stores) and issues its copy to the
card on a stream of the stager's own.
:meth:`claim` gathers a batch's frames from their device slots on the
caller's stream and waits for a frame being staged. A frame not yet
started goes to the front of the queue and is waited for when a slot is
free for it; else it is taken back (the caller hands it over itself). On
an H100's host, taking back every frame not started had the caller's
staging on torch's intra-op threads contend with these for the cores
whenever they fell behind (671 frames/s against 1,500 inline).
:meth:`release` hands the slots back once the work the caller queued
has run. So at most ``slots``
frames are staged ahead, a page-locked slot is rewritten only after its
copy to the card and a device slot only after its gather. The threads
end when the stager is closed or collected.
"""
from __future__ import annotations

import ctypes
import os
import weakref

import numpy as np
import torch

from repro_torch._device import raw_stream
from . import _build

__all__ = ["AHEAD", "TAKEN", "WAITED", "Stager", "copy_threads", "layout"]

# What claiming a frame found (:meth:`Stager.claim`, the codes of
# ``stager_claim``): its copy to the card issued before the claim, issued
# while the claim waited, or not started with no slot free, so taken back.
TAKEN, WAITED, AHEAD = 0, 1, 2

_NP = {torch.float32: np.dtype(np.float32), torch.uint8: np.dtype(np.uint8)}


def copy_threads() -> int:
    """Threads that copy frames. The stager's threads are as many as the
    CPUs this process may run on, less one for the serving thread, at
    most torch's intra-op threads; one of them is the lead, which hands
    frames out, and the others copy (at least one). On an H100's host (8
    CPUs) 6 copying threads matched or beat 7, which left the serving
    thread no core of its own beside the lead."""
    workers = min(len(os.sched_getaffinity(0)) - 1, torch.get_num_threads())
    return max(1, workers - 1)


def layout(frame, dtype: torch.dtype) -> tuple[int, int, int, int] | None:
    """(address, rows, row bytes, pitch) of ``frame`` when the stager can
    copy it as it lies: an (h, w) numpy array or CPU tensor of ``dtype``
    (float32 or uint8) whose rows are contiguous and ascending. None for
    anything else (another type, a tensor on a device, a flipped or
    column-strided view, an empty frame)."""
    if isinstance(frame, np.ndarray):
        if frame.dtype != _NP.get(dtype) or frame.ndim != 2:
            return None
        addr = frame.__array_interface__["data"][0]
        (h, w), (pitch, step) = frame.shape, frame.strides
        item = frame.itemsize
    elif isinstance(frame, torch.Tensor):
        if frame.dtype != dtype or frame.dim() != 2 \
                or frame.device.type != "cpu":
            return None
        addr = frame.data_ptr()
        (h, w), item = frame.shape, frame.element_size()
        pitch, step = frame.stride(0) * item, frame.stride(1) * item
    else:
        return None
    if h == 0 or w == 0 or step != item or (h > 1 and pitch < w * item):
        return None
    return addr, h, w * item, pitch


def _library() -> ctypes.CDLL:
    return _bind(_build.load("stencil_pipeline"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the stager's argument and result types set."""
    if lib.stager_create.restype is not ctypes.c_void_p:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stager_create.argtypes = [i, i, ll, vp, vp, i,
                                      ctypes.POINTER(i)]
        lib.stager_create.restype = vp
        lib.stager_destroy.argtypes = [vp]
        lib.stager_destroy.restype = None
        lib.stager_put.argtypes = [vp, vp, ll, ll, ll]
        lib.stager_put.restype = ll
        lib.stager_claim.argtypes = [vp, i, ctypes.POINTER(ll),
                                     ctypes.POINTER(vp), vp,
                                     ctypes.POINTER(i)]
        lib.stager_claim.restype = i
        lib.stager_release.argtypes = [vp, i, ctypes.POINTER(ll), vp]
        lib.stager_release.restype = i
        lib.stager_counts.argtypes = [vp, ctypes.POINTER(i),
                                      ctypes.POINTER(i)]
        lib.stager_counts.restype = i
        lib.stencil_pipeline_error_string.argtypes = [i]
        lib.stencil_pipeline_error_string.restype = ctypes.c_char_p
    return lib


def _ring(device: torch.device, slots: int, slot_bytes: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring's page-locked and device memory, ``slots`` x
    ``slot_bytes`` bytes each, from torch's caching allocators."""
    return (torch.empty((slots, slot_bytes), dtype=torch.uint8,
                        pin_memory=True),
            torch.empty((slots, slot_bytes), dtype=torch.uint8,
                        device=device))


def _stream(device: torch.device) -> int:
    """The cudaStream_t of the calling thread's current stream on
    ``device``."""
    return raw_stream(_index(device))


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _destroy(lib, handle, pinned, dev) -> None:
    """Join the stager's threads and wait for its copies; ``pinned`` and
    ``dev``, held until here, are freed after."""
    lib.stager_destroy(handle)


class Stager:
    """A ring of ``slots`` slots of ``slot_bytes`` on card ``device``, a
    team of ``threads`` (default :func:`copy_threads`) that fill them,
    and their lead."""

    def __init__(self, device: torch.device, slots: int, slot_bytes: int,
                 threads: int | None = None):
        self.device = device
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.threads = threads if threads is not None else copy_threads()
        self._lib = lib = _library()
        pinned, dev = _ring(device, slots, slot_bytes)
        err = ctypes.c_int(0)
        handle = lib.stager_create(_index(device), slots, slot_bytes,
                                   pinned.data_ptr(), dev.data_ptr(),
                                   self.threads, ctypes.byref(err))
        if not handle:
            raise RuntimeError(f"stager_create failed: {self._error(err)}")
        self._handle = handle
        self._frames: dict[int, object] = {}   # ticket: its frame
        self._close = weakref.finalize(self, _destroy, lib, handle, pinned,
                                       dev)

    def _error(self, code) -> str:
        code = int(getattr(code, "value", code))
        if code < 0:
            return "no thread could be started"
        return self._lib.stencil_pipeline_error_string(code).decode()

    def put(self, frame, where: tuple[int, int, int, int]) -> int:
        """Queue ``frame``, laid out as ``where`` (:func:`layout`; at most
        ``slot_bytes``), to be staged; returns its ticket. The frame is
        held until its ticket is released, and must not change before."""
        addr, rows, row_bytes, pitch = where
        if rows * row_bytes > self.slot_bytes:
            raise ValueError(f"a frame of {rows * row_bytes} bytes, slots "
                             f"of {self.slot_bytes}")
        ticket = self._lib.stager_put(self._handle, addr, rows, row_bytes,
                                      pitch)
        self._frames[ticket] = frame
        return ticket

    def claim(self, tickets: list[int], dsts: list[torch.Tensor]
              ) -> list[int]:
        """Claim ``tickets``: each frame staged is copied into the
        matching tensor of ``dsts`` (contiguous, on the card, the frame's
        bytes) on the current stream. Per ticket: :data:`AHEAD` (its copy
        to the card was issued before this call), :data:`WAITED` (being
        staged, or not started with a slot free for it: waited for) or
        :data:`TAKEN` (not started with no slot free: taken back, nothing
        copied). A ticket can be claimed again until it is released."""
        n = len(tickets)
        ids = (ctypes.c_longlong * n)(*tickets)
        ptrs = (ctypes.c_void_p * n)(*[d.data_ptr() for d in dsts])
        out = (ctypes.c_int * n)()
        rc = self._lib.stager_claim(self._handle, n, ids, ptrs,
                                    _stream(self.device), out)
        if rc != 0:
            raise RuntimeError(f"stager_claim failed: {self._error(rc)}")
        return list(out)

    def release(self, tickets: list[int]) -> None:
        """Hand back ``tickets``' slots once the work queued so far on
        the current stream has run (a ticket not yet started is dropped,
        one being staged is waited for), and let go of their frames. A
        failed event record is ordered by a host synchronise instead, in
        the library, so nothing is left to report here."""
        n = len(tickets)
        self._lib.stager_release(self._handle, n,
                                 (ctypes.c_longlong * n)(*tickets),
                                 _stream(self.device))
        for t in tickets:
            self._frames.pop(t, None)

    def counts(self) -> tuple[int, int]:
        """(tickets waiting for a slot, slots held)."""
        pending, held = ctypes.c_int(0), ctypes.c_int(0)
        rc = self._lib.stager_counts(self._handle, ctypes.byref(pending),
                                     ctypes.byref(held))
        if rc != 0:
            raise RuntimeError(f"a thread of the stager failed: "
                               f"{self._error(rc)}")
        return pending.value, held.value

    def close(self) -> None:
        """Join the threads and free the ring (also done on collection)."""
        self._close()
