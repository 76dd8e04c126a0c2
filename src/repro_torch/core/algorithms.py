"""Evaluation pipelines (paper Tbl. 3) + eager PyTorch reference executor.

Stage/MC counts match Tbl. 3 exactly (stage counts include the input and
output stages, per the Darkroom-style DSL). The arithmetic payloads are
representative stencil math (separable Gaussian, Sobel, Laplacian, NMS,
unsharp, 18x1 cross-correlation) so functional tests are meaningful.

Window convention (matches the scheduling model / simulator): the window
for output pixel (r, x) covers rows r-sh+1..r and cols x-sw+1..x of each
producer, with zero padding — i.e. bottom-right (causal) alignment.

Payloads. Every stage payload is a :class:`Payload`, which carries the
stage's math in the two forms the port runs it in:

  * ``payload(wins)`` — eager PyTorch over a dict of (..., sh, sw) window
    tensors, (..., st, sh, sw) for a temporal edge, keyed by
    :func:`~repro_torch.core.dag.window_keys`. It keeps
    the reference's accumulation order (dy-major sums of scalar taps) and
    never fuses a multiply into an add, so on one set of inputs it gives
    the same bits as the CUDA kernel.
  * ``payload.op`` / ``weights`` / ``consts`` / ``operands(keys, edges)``
    — an op code, its float32 constants, and the operand order resolved
    from the window keys, which ``kernels/stencil_pipeline.py`` writes
    into the per-plan stage table that the one compiled kernel walks.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .dag import Edge, PipelineDAG, window_keys
from .dsl import Pipeline


def _f32(x: float) -> float:
    """``x`` rounded to float32 — the value a float32 kernel multiplies by."""
    return float(np.float32(x))


class Payload:
    """A stage's window function as eager math plus a kernel op.

    ``op`` names the kernel operation; ``weights`` (float32, 2-D) are its
    taps, ``consts`` its float32 scalars. ``order(keys, edges)`` maps the
    stage's in-edges (window-key order) to the op's operand order — the
    reference selects operands by key name, sorted key order or window
    shape, and that choice is resolved once per plan on the host.
    """

    def __init__(self, op: str, fn: Callable,
                 weights: np.ndarray | None = None,
                 consts: Sequence[float] = (),
                 order: Callable[[list[str], list[Edge]], list[int]]
                 | None = None):
        self.op = op
        self._fn = fn
        self.weights = weights
        self.consts = tuple(_f32(c) for c in consts)
        self._order = order

    def __call__(self, wins: dict[str, torch.Tensor]) -> torch.Tensor:
        return self._fn(wins)

    @property
    def eager(self) -> Callable:
        """The plain window function (what a stage written by hand in
        torch would be; ``expr.bare_pipeline`` runs it through the
        kernel's expression body)."""
        return self._fn

    def operands(self, keys: list[str], edges: list[Edge]) -> list[int]:
        """In-edge indices in the op's operand order."""
        if self._order is None:
            return list(range(len(keys)))
        return self._order(keys, edges)

    def __repr__(self) -> str:
        return f"Payload({self.op!r})"


# ------------------------------------------------------------- window fns
def _single(wins):
    (v,) = wins.values()
    return v


def conv_fn(weights: np.ndarray) -> Payload:
    w = np.asarray(weights, dtype=np.float32)
    taps = [(dy, dx, float(w[dy, dx]))
            for dy in range(w.shape[0]) for dx in range(w.shape[1])]

    def fn(wins):
        win = _single(wins)
        acc = None
        for dy, dx, t in taps:
            term = t * win[..., dy, dx]
            acc = term if acc is None else acc + term
        return acc
    return Payload("conv", fn, weights=w)


def _square(wins):
    v = _single(wins)[..., 0, 0]
    return v * v


def _identity(wins):
    return _single(wins)[..., 0, 0]


def _sorted_keys(keys, edges):
    return sorted(range(len(keys)), key=lambda i: keys[i])


_MAG_EPS = _f32(1e-6)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device. PyTorch's
    CPU float32 sqrt can be 1 ULP off; the float64 root of a float32
    value rounds to the correctly rounded float32 root (53 >= 2*24 + 2
    bits), which is what the kernel's __fsqrt_rn gives."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _mag(wins):
    a, b = (wins[k][..., 0, 0] for k in sorted(wins))
    return _sqrt_rn(a * a + b * b + _MAG_EPS)


def _prod(wins):
    a, b = (wins[k][..., 0, 0] for k in sorted(wins))
    return a * b


def _nms(wins):
    win = _single(wins)
    center = win[..., -2, -2] if win.shape[-1] >= 2 else win[..., -1, -1]
    mx = win.amax(dim=(-2, -1))
    return torch.where(center >= mx, center, 0.0)


def thresh(lo: float = 0.1) -> Payload:
    """Keep values above ``lo`` (compared in float32), zero the rest."""
    lo32 = _f32(lo)

    def fn(wins):
        v = _single(wins)[..., 0, 0]
        return torch.where(v > lo32, v, 0.0)
    return Payload("thresh", fn, consts=(lo32,))


square_fn = Payload("square", _square)
identity_fn = Payload("identity", _identity)
mag_fn = Payload("mag", _mag, consts=(_MAG_EPS,), order=_sorted_keys)
prod_fn = Payload("prod", _prod, order=_sorted_keys)
nms_fn = Payload("nms", _nms)
thresh_fn = thresh()


def gauss1d(n: int) -> np.ndarray:
    x = np.arange(n) - (n - 1) / 2
    g = np.exp(-0.5 * (x / max(n / 4.0, 1.0)) ** 2)
    return (g / g.sum()).astype(np.float32)


SOBEL_X = np.array([[-1.0, 0.0, 1.0]], dtype=np.float32)          # 1x3
SOBEL_Y = SOBEL_X.T                                               # 3x1
LAPLACE = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
G5H = gauss1d(5)[None, :]
G5V = gauss1d(5)[:, None]
G3 = np.outer(gauss1d(3), gauss1d(3)).astype(np.float32)
XCORR_T = gauss1d(18)[:, None]                                    # 18x1

_UNSHARP_K = _f32(1.5)
_HARRIS_K = _f32(0.04)


def _in_first(keys, edges):
    i = keys.index("in")
    return [i] + [j for j in range(len(keys)) if j != i][:1]


def _unsharp(wins):
    orig = wins["in"][..., 0, 0]
    blur = [v for k, v in wins.items() if k != "in"][0][..., 0, 0]
    return orig + _UNSHARP_K * (orig - blur)


_XCORR_TAPS = [float(t) for t in XCORR_T[:, 0]]


def _tall_then_center(keys, edges):
    tall = next(i for i, e in enumerate(edges) if e.sh == len(_XCORR_TAPS))
    center = next(i for i, e in enumerate(edges) if e.sh == 1)
    return [tall, center]


def _xcorr(wins):
    tall = [v for v in wins.values() if v.shape[-2] == 18][0]
    center = [v for v in wins.values() if v.shape[-2] == 1][0][..., 0, 0]
    corr = None
    for dy, t in enumerate(_XCORR_TAPS):
        term = t * tall[..., dy, 0]
        corr = term if corr is None else corr + term
    return corr - center


def _by_name(*names):
    def order(keys, edges):
        return [keys.index(n) for n in names]
    return order


def _denoise_comb(wins):
    orig = wins["in"][..., 0, 0]
    blur = wins["b"][..., 0, 0]
    lap = wins["lap"][..., 0, 0]
    edge_w = torch.clamp(torch.abs(lap), 0.0, 1.0)
    return edge_w * orig + (1.0 - edge_w) * blur


def _harris_resp(wins):
    v = _single(wins)[..., 0, 0]
    return v - _HARRIS_K * v * v


unsharp_fn = Payload("unsharp", _unsharp, consts=(_UNSHARP_K,),
                     order=_in_first)
xcorr_fn = Payload("xcorr", _xcorr, weights=XCORR_T,
                   order=_tall_then_center)
denoise_comb_fn = Payload("denoise_comb", _denoise_comb,
                          order=_by_name("in", "b", "lap"))
harris_resp_fn = Payload("harris_resp", _harris_resp, consts=(_HARRIS_K,))


# ------------------------------------------------------------- pipelines
def canny_s() -> PipelineDAG:
    """9 stages, 0 MC — linear chain."""
    p = Pipeline("canny-s")
    x = p.input("in")
    bx = p.stage("bx", [(x, 1, 5)], conv_fn(G5H))
    by = p.stage("by", [(bx, 5, 1)], conv_fn(G5V))
    gx = p.stage("gx", [(by, 1, 3)], conv_fn(SOBEL_X))
    gy = p.stage("gy", [(gx, 3, 1)], conv_fn(SOBEL_Y))
    sq = p.stage("sq", [(gy, 1, 1)], square_fn)
    nms = p.stage("nms", [(sq, 3, 3)], nms_fn)
    th = p.stage("th", [(nms, 1, 1)], thresh_fn)
    p.output("out", [(th, 1, 1)])
    return p.build()


def canny_m() -> PipelineDAG:
    """10 stages, 1 MC — blurred image feeds both gradient directions."""
    p = Pipeline("canny-m")
    x = p.input("in")
    bx = p.stage("bx", [(x, 1, 5)], conv_fn(G5H))
    by = p.stage("by", [(bx, 5, 1)], conv_fn(G5V))       # MC stage
    gx = p.stage("gx", [(by, 1, 3)], conv_fn(SOBEL_X))
    gy = p.stage("gy", [(by, 3, 1)], conv_fn(SOBEL_Y))
    mag = p.stage("mag", [(gx, 1, 1), (gy, 1, 1)], mag_fn)
    nms = p.stage("nms", [(mag, 3, 3)], nms_fn)
    hyst = p.stage("hyst", [(nms, 3, 3)], nms_fn)
    th = p.stage("th", [(hyst, 1, 1)], thresh_fn)
    p.output("out", [(th, 1, 1)])
    return p.build()


def harris_s() -> PipelineDAG:
    """7 stages, 0 MC."""
    p = Pipeline("harris-s")
    x = p.input("in")
    g = p.stage("g", [(x, 1, 3)], conv_fn(SOBEL_X))
    g2 = p.stage("g2", [(g, 1, 1)], square_fn)
    s = p.stage("s", [(g2, 3, 3)], conv_fn(G3))
    r = p.stage("r", [(s, 1, 1)], harris_resp_fn)
    nms = p.stage("nms", [(r, 3, 3)], nms_fn)
    p.output("out", [(nms, 1, 1)])
    return p.build()


def harris_m() -> PipelineDAG:
    """7 stages, 1 MC — the input feeds both gradient directions."""
    p = Pipeline("harris-m")
    x = p.input("in")                                    # MC stage
    gx = p.stage("gx", [(x, 1, 3)], conv_fn(SOBEL_X))
    gy = p.stage("gy", [(x, 3, 1)], conv_fn(SOBEL_Y))
    ixy = p.stage("ixy", [(gx, 1, 1), (gy, 1, 1)], prod_fn)
    s = p.stage("s", [(ixy, 3, 3)], conv_fn(G3))
    r = p.stage("r", [(s, 1, 1)], harris_resp_fn)
    p.output("out", [(r, 1, 1)])
    return p.build()


def unsharp_m() -> PipelineDAG:
    """5 stages, 1 MC — classic unsharp mask (paper Sec. 1, 3.1)."""
    p = Pipeline("unsharp-m")
    x = p.input("in")                                    # MC stage
    bx = p.stage("bx", [(x, 1, 5)], conv_fn(G5H))
    by = p.stage("by", [(bx, 5, 1)], conv_fn(G5V))
    sh = p.stage("sharp", [(x, 1, 1), (by, 1, 1)], unsharp_fn)
    p.output("out", [(sh, 1, 1)])
    return p.build()


def xcorr_m() -> PipelineDAG:
    """3 stages, 1 MC — 18x1 template correlation (paper Sec. 8.3)."""
    p = Pipeline("xcorr-m")
    x = p.input("in")                                    # MC stage
    xc = p.stage("xc", [(x, 18, 1), (x, 1, 1)], xcorr_fn)
    p.output("out", [(xc, 1, 1)])
    return p.build()


def denoise_m() -> PipelineDAG:
    """5 stages, 2 MC — edge-aware blend."""
    p = Pipeline("denoise-m")
    x = p.input("in")                                    # MC stage 1
    b = p.stage("b", [(x, 3, 3)], conv_fn(G3))           # MC stage 2
    lap = p.stage("lap", [(b, 3, 3)], conv_fn(LAPLACE))
    comb = p.stage("comb", [(x, 1, 1), (b, 1, 1), (lap, 1, 1)],
                   denoise_comb_fn)
    p.output("out", [(comb, 1, 1)])
    return p.build()


ALGORITHMS = {
    "canny-s": canny_s, "canny-m": canny_m,
    "harris-s": harris_s, "harris-m": harris_m,
    "unsharp-m": unsharp_m, "xcorr-m": xcorr_m, "denoise-m": denoise_m,
}

# ---------------------------------------------------- temporal window fns
# Temporal windows arrive as [..., st, sh, sw] (axis -3 is time, causal:
# index st-1 is the current frame, index 0 the oldest; frames before the
# stream start read as zero, exactly like the spatial zero padding).
# Reductions run dt-major, then dy, then dx, one rounding per operation —
# the reference's order, which the kernel's ``stmean`` op repeats.
def stmean_fn(st: int, sh: int = 1, sw: int = 1) -> Payload:
    """Mean over an (st, sh, sw) spatio-temporal box: the sum in
    dt, dy, dx order, then one multiply by float32(1 / (st*sh*sw))."""
    k = _f32(1.0 / float(st * sh * sw))
    cells = [(dt, dy, dx) for dt in range(st) for dy in range(sh)
             for dx in range(sw)]

    def fn(wins):
        win = _single(wins)
        acc = None
        for dt, dy, dx in cells:
            term = win[..., dt, dy, dx]
            acc = term if acc is None else acc + term
        return acc * k
    return Payload("stmean", fn, consts=(k,))


def _frame_diff(wins):
    win = _single(wins)
    return torch.abs(win[..., 1, 0, 0] - win[..., 0, 0, 0])


_BG_LO = _f32(0.25)


def _bg_subtract(wins):
    cur = wins["in"][..., 0, 0]
    bg = [v for k, v in wins.items() if k != "in"][0][..., 0, 0]
    d = torch.abs(cur - bg)
    return torch.where(d > _BG_LO, d, 0.0)


# |current - previous| of a (2, 1, 1) temporal window
frame_diff_fn = Payload("frame_diff", _frame_diff)
# foreground mask: |current - background|, kept above 0.25
bg_subtract_fn = Payload("bg_subtract", _bg_subtract, consts=(_BG_LO,),
                         order=_in_first)
# unsharp along time: unsharp's math with the temporal average as the blur
tunsharp_fn = Payload("unsharp", _unsharp, consts=(_UNSHARP_K,),
                      order=_in_first)


# ------------------------------------------------------- video pipelines
def tdenoise_t() -> PipelineDAG:
    """Temporal-average denoise: mean of the last 4 frames, then a 3x3
    spatial blur — a spatial stage downstream of a temporal one."""
    p = Pipeline("tdenoise-t")
    x = p.input("in")
    ta = p.stage("tavg", [(x, 4, 1, 1)], stmean_fn(4))
    b = p.stage("blur", [(ta, 3, 3)], conv_fn(G3))
    p.output("out", [(b, 1, 1)])
    return p.build()


def tmotion_t() -> PipelineDAG:
    """Frame-difference motion mask: |in_t - in_{t-1}|, spatially
    smoothed, thresholded."""
    p = Pipeline("tmotion-t")
    x = p.input("in")
    d = p.stage("diff", [(x, 2, 1, 1)], frame_diff_fn)
    b = p.stage("blur", [(d, 3, 3)], conv_fn(G3))
    th = p.stage("th", [(b, 1, 1)], thresh(0.05))
    p.output("out", [(th, 1, 1)])
    return p.build()


def tbackground_t() -> PipelineDAG:
    """Background subtraction with a running mean: the background
    estimate is the mean of the last 8 input frames."""
    p = Pipeline("tbackground-t")
    x = p.input("in")                                    # MC stage
    bg = p.stage("bg", [(x, 8, 1, 1)], stmean_fn(8))
    fg = p.stage("fg", [(x, 1, 1), (bg, 1, 1)], bg_subtract_fn)
    p.output("out", [(fg, 1, 1)])
    return p.build()


def tunsharp_t() -> PipelineDAG:
    """3-frame unsharp-over-time: sharpen against a 3x3x3 spatio-temporal
    mean — the one pipeline whose temporal taps carry a spatial window."""
    p = Pipeline("tunsharp-t")
    x = p.input("in")                                    # MC stage
    sa = p.stage("stavg", [(x, 3, 3, 3)], stmean_fn(3, 3, 3))
    sh = p.stage("sharp", [(x, 1, 1), (sa, 1, 1)], tunsharp_fn)
    p.output("out", [(sh, 1, 1)])
    return p.build()


VIDEO_ALGORITHMS = {
    "tdenoise-t": tdenoise_t, "tmotion-t": tmotion_t,
    "tbackground-t": tbackground_t, "tunsharp-t": tunsharp_t,
}

# Paper Sec. 7: 320p = 480x320, 1080p = 1920x1080 (W x H)
RESOLUTIONS = {"320p": (480, 320), "1080p": (1920, 1080)}


def synthetic_pipeline(n_stages: int, mc_fraction: float = 1 / 3,
                       seed: int = 0) -> PipelineDAG:
    """Random chains with MC branches for the Sec. 8.2 scalability sweep."""
    rng = np.random.RandomState(seed)
    p = Pipeline(f"synth-{n_stages}")
    prev = p.input("in")
    budget = n_stages - 3            # minus input, final join, output
    n_mc = max(1, int(n_stages * mc_fraction))
    pending = []   # side branches waiting to re-join
    i = 0
    side_spent = 0
    while i + side_spent < budget:
        i += 1
        reads = [(prev, int(rng.choice([1, 3])), int(rng.choice([1, 3])))]
        if pending and rng.rand() < 0.5:
            side = pending.pop()
            reads.append((side, 1, 1))
        cur = p.stage(f"k{i}", reads, identity_fn)
        if side_spent < n_mc and i + side_spent + 1 < budget \
                and rng.rand() < 0.6:
            side = p.stage(f"k{i}b", [(prev, 3, 1)], identity_fn)
            pending.append(side)
            side_spent += 1
        prev = cur
    # drain leftover branches into the final stage
    reads = [(prev, 1, 1)] + [(s, 1, 1) for s in pending]
    last = p.stage("klast", reads, identity_fn)
    p.output("out", [(last, 1, 1)])
    return p.build()


# -------------------------------------------------------- reference exec
def _windows(img: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, sh, sw) bottom-right-aligned windows,
    zero padded — a strided view over one padded copy of ``img``."""
    pad = F.pad(img, (sw - 1, 0, sh - 1, 0))
    return pad.unfold(-2, sh, 1).unfold(-2, sw, 1)


def run_stages(dag: PipelineDAG, inputs: Mapping,
                tap: Callable[[str, int], torch.Tensor] | None
                ) -> dict[str, torch.Tensor]:
    """Every stage over whole frames, topo order. A temporal window of
    st frames stacks, on axis -3, ``tap(producer, j)`` for j = st-1 .. 1
    (j frames back) and the producer's current value last."""
    vals: dict[str, torch.Tensor] = {}
    for name in dag.topo_order:
        st = dag.stages[name]
        if st.is_input:
            vals[name] = torch.as_tensor(inputs[name], dtype=torch.float32)
            continue
        ins = dag.in_edges(name)
        if st.fn is None:  # relay or output: identity on single producer
            vals[name] = vals[ins[0].producer]
            continue
        wins = {}
        for k, e in zip(window_keys(ins), ins):
            if e.st == 1:
                wins[k] = _windows(vals[e.producer], e.sh, e.sw)
                continue
            wins[k] = torch.stack(
                [_windows(tap(e.producer, j) if j else vals[e.producer],
                          e.sh, e.sw)
                 for j in range(e.st - 1, -1, -1)], dim=-3)
        vals[name] = st.fn(wins)
    return vals


def execute_reference(dag: PipelineDAG, inputs: dict
                      ) -> dict[str, torch.Tensor]:
    """Eager oracle: run every stage over full images, topo order.

    Inputs are (H, W) or batched (..., H, W) arrays or tensors; tensors
    stay on their device. Single-frame only: a temporal pipeline (any
    edge with st > 1) has no meaning on one frame.
    """
    if dag.is_temporal():
        raise ValueError(f"{dag.name} has temporal edges; use "
                         f"execute_reference_video")
    return run_stages(dag, inputs, None)


def execute_reference_video(dag: PipelineDAG, videos: Mapping,
                            return_history: bool = False):
    """Multi-frame oracle: (T, H, W) inputs -> (T, H, W) output.

    Frames run in stream order through plain per-frame stage evaluation;
    each temporal producer's last d-1 frames are kept in a history list
    (most recent first). Frames before t = 0 read as zero — the same
    causal zero padding as the spatial frame top/left.

    With ``return_history=True`` returns ``(output, history)`` where
    ``history`` maps each temporal producer to its last d-1 frames,
    newest first (shorter when T < d-1) — the state a serving session
    needs to resume the stream.
    """
    first = next(iter(videos.values()))
    depths = dag.temporal_depths()
    history: dict[str, list[torch.Tensor]] = {p: [] for p in depths}
    zero = torch.zeros(tuple(first.shape[1:]), dtype=torch.float32,
                       device=torch.as_tensor(first[:1]).device)

    def tap(p: str, j: int) -> torch.Tensor:
        past = history[p]
        return past[j - 1] if j <= len(past) else zero

    outs = []
    for t in range(first.shape[0]):
        vals = run_stages(dag, {n: v[t] for n, v in videos.items()}, tap)
        for p, d in depths.items():
            history[p] = [vals[p]] + history[p][:d - 2]
        outs.append(vals[dag.output_stages()[0]])
    out = torch.stack(outs)
    if return_history:
        return out, history
    return out
