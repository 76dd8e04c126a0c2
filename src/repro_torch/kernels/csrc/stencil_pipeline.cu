// Fused line-buffered stencil pipeline on Hopper (sm_90a).
//
// Replaces repro/kernels/stencil_pipeline.py::_build_pipeline_call of the
// JAX package: the single-frame spatial kernel, its batched grid, its
// temporal form (history taps and frame outputs), and its prefetch_depth
// >= 2 form (input rings filled by asynchronous copies ahead of compute).
// One launch runs a whole pipeline DAG over a batch of frames; every
// intermediate stage lives only in shared-memory ring line buffers (the
// paper's line buffer), so device memory sees each input pixel read once
// and each output pixel written once.
//
// What bounds it: per frame it must move (n_inputs + 1) * h * w * 4 bytes
// -- 16.6 MB for one 1080p input and output, about 5 us at the 3.35 TB/s
// of an H100 SXM -- against a few tens of float32 operations per pixel,
// so the bound is device-memory bytes. A temporal launch adds the history
// frames it reads (d-1 per temporal producer) and the frames of internal
// temporal producers it writes. What holds the kernel back in practice is
// the work per element and the waits between levels: every stage reads
// its producers' windows from shared memory and the block synchronises
// between DAG levels. The design spends as few instructions and
// shared-memory accesses per window tap as it can.
//
// Work split. The TPU kernel walks a frame sequentially on one core with
// rings carried across grid steps. Here one CTA owns one (frame, column
// strip, row band) and loops over row groups of R rows top to bottom,
// keeping one ring per producer in dynamic shared memory:
//   * a strip of strip_w output columns recomputes its left halo of
//     halo_left columns (the DAG's cumulative stencil width, rounded up
//     to 4 where 16-byte vectors apply) from real input; a band
//     recomputes its top halo of halo_up rows likewise. A CTA computes
//     ncols columns, the strip and its halo rounded up to a warp.
//   * a CTA owns exactly one frame of the batch, so batched frames never
//     see one another's ring residue.
//   * rows at and below h (the last partial row group) and columns at
//     and beyond w compute from zero input and are never stored.
//
// Per stage and row group, a thread owns fixed columns (threadIdx.x,
// + blockDim.x, ...) and walks the R rows down each. A window of sh rows
// by sw columns lives in registers: per row the thread loads the sw new
// values of the row entering the window and shifts the others, so each
// producer value is read from shared memory once per row and column it
// feeds, not once per tap. Neighbouring threads read neighbouring
// columns, so the warp's loads are free of bank conflicts.
//
// No division or test on the tap path:
//   * ring rows are found from a per-ring table of the slot that holds
//     the row group's first row, advanced once per row group with a
//     compare and subtract; a window's row walks the ring with one
//     compare per row.
//   * the frame's zero border is stored, not tested: each ring row holds
//     `pad` columns (the widest window's sw - 1) left of the CTA's
//     columns, the rings are zero-filled once at CTA start, and a stage
//     writes 0 for frame column < 0 (once per element, where it writes
//     its ring). Rows above the band's first computed row rlo are slots
//     not yet written, hence zero, because a ring holds at least the
//     R + sh - 1 rows its widest reader spans. Only frame row < 0 or
//     column < 0 reads as the frame edge's zero; a halo is computed from
//     real input and never zero-filled (mag maps 0 to sqrt(1e-6)).
//   * the op and the window shape are resolved outside the pixel loop:
//     build_program names each stage's body (enum Kind): a feed, a
//     pointwise op on 1x1 operands, or one of the window shapes the
//     registered pipelines use, unrolled with the weights in registers.
//     Any other shape takes the generic body, which reads every tap from
//     shared memory.
//   * stages of one DAG level read only rings of earlier levels, so the
//     block synchronises once per level (S_SYNC), not once per stage.
//
// Vector I/O. Where w % 4 == 0, the strip starts on a multiple of 4 and
// every tensor is 16-byte aligned (H_VEC; 1080p qualifies), feeds are read
// and outputs written as float4: a feed stage maps threads to (row,
// 4-column) items, and the final stage writes its R rows to an output
// block in shared memory that the CTA stores as float4 after the level's
// barrier. Odd widths take scalar loads and stores in the same template.
//
// Temporal pipelines. Each history tap (producer p, j frames back) is a
// pseudo-input stage (OP_TAP) with its own ring, filled like an input
// over the CTA's strip and band halos. Frame b of the launch reads tap j
// from input frame b - j of the same launch when b >= j (a chunk of
// consecutive frames serves its own history), else from slot j - b - 1
// of p's frame-ring state (newest first), so no history frame is copied
// to build the feed. A producer's rings lie consecutively, oldest tap
// first and its live ring last, so an operand (first ring, st, sh, sw)
// reads time index dt from ring first + dt. An internal temporal
// producer also writes its frame to an extra output, which the host
// rolls into the state; such a launch holds one frame.
//
// The pipeline comes as a stage table built once per plan on the host
// (repro_torch/kernels/stencil_pipeline.py::build_program) and passed by
// value as a __grid_constant__ parameter: per stage an op code, its body,
// its own ring, its operands (first ring, st, sh, sw), offsets into a
// float32 constant table and whether a barrier follows it. For pipelines
// of built-in payload ops no source is generated per DAG: one shared
// library of four instantiations serves them all. A program with a stage
// function written by hand in torch gets a library of its own (below).
//
// Numerics: every product and sum goes through the _rn intrinsics (and the
// library is built with -fmad=false), in the reference's order, and sqrt
// is __fsqrt_rn. The eager PyTorch version does one rounding per
// operation in the same order, so the two agree bit for bit. A max or a
// clamp passes a NaN on (max_nan / min_nan), as amax and torch.clamp do,
// so NaN frames agree too, NaN positions equal.
//
// Prefetch depth d >= 2 (the kPrefetch instantiations). The TPU kernel
// stages every feed through a (d, R, W) VMEM ring filled by
// pltpu.make_async_copy, so step t computes on slot t % d while steps
// t+1..t+d-1 load. Here there is no staging ring: each feed stage (an
// input, or a history tap) copies straight into its own line ring, which
// build_program grows to max(d * R + sh - 1, the plan's lines) rows (sh:
// the tallest window that reads it); the other rings keep their depth-1
// rows. A CTA's row groups are its steps t = 0, 1, ...; the copies of
// step u land at the slots of rows rlo + u * R.. : the row table's slot
// plus (u - t) * R, one compare and subtract, since (d - 1) * R < rows.
// The clock, one commit group per step (an empty one past the band's
// last step), so cp.async.wait_group counts steps:
//   * the prologue zero-fills the rings, synchronises (the copies land
//     on zeroed rows) and issues steps 0..d-1;
//   * the copies of a step must land and then pass a barrier before any
//     stage reads them, since the column-owning threads that read them
//     are not the copying ones: each thread waits for its copies of step
//     t at the top of row group t (wait_group d - 1), and the feeds'
//     barrier shows them to all, as at depth 1. That barrier also keeps
//     a fast thread of row group t + 1 from writing the output block
//     while a slow one still stores row group t's;
//   * after the row group's last barrier no stage reads step t's rows
//     any more, and the kernel refills with step t + d, from the next
//     row group's table; its slots alias rows at most row0 + R - sh,
//     which later steps never read.
// The copies use the (row, 4-column) item walk of the depth-1 feed, 16
// bytes each where H_VEC holds, else 4 bytes (src-size 0 writes the zero
// of the frame edge). A feed that is also the final stage moves its R
// rows from the ring to the output block, each thread the elements it
// copied. The zero border holds as at depth 1: the prologue writes slots
// 0..d*R-1 only, and a grown ring has at least d * R + sh - 1 rows, so
// the sh - 1 slots that stand for the rows above rlo stay zero until
// step 0 has read them. With H_POISON the kernel first fills with NaN
// every slot a copy writes before anything reads it (S_LEAD rows of each
// feed ring, not the zero tail), so a read that overtakes its copy shows.
// Depths above 9 stay correct but keep at most 8 steps in flight, since
// wait_group takes an immediate (at most 7 here). The depth-1
// instantiations compile to the kernel without any of this.
//
// Expression stages (K_EXPR). A stage whose function is not one of the op
// codes above was traced on the host and lowered to a straight-line
// program of float32 scalar instructions (repro_torch/core/expr.py). As
// Pallas compiles a stage's traced function into the TPU kernel's body,
// the port compiles the lowered program into this kernel:
// repro_torch/kernels/expr_codegen.py writes each distinct lowered stage
// as one __device__ function shaped like the payload window bodies (a
// sliding Window<sh, sw> in registers per operand and time index, the
// stage's constants read once from its slice of the constant table, one
// local per instruction, the result to Sink::put), and a dispatcher,
// stage_generated<kTemporal>, that runs the one whose id is S[S_XID].
// The fragment is included at the STENCIL_EXPR hook below, in a build of
// this file that holds only the one instantiation the program launches
// (STENCIL_EXPR_TEMPORAL, STENCIL_EXPR_PREFETCH; kernels/_build.py).
// Libraries are cached on disk by content hash, and the constants are
// not in the source, so programs that differ only in constants share
// one. Sums, differences,
// products, quotients and roots are _rn intrinsics, so they equal the
// eager function's step by step; max and min pass a NaN on as
// torch.maximum does; exp, log and tanh are the CUDA library's. Without
// the hook (the shared library) K_EXPR runs nothing, and a launch of a
// program with an expression stage there is refused (H_EXPR).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kHdr = 24;
constexpr int kMaxStages = 24;
constexpr int kStageInts = 24;
constexpr int kMaxRings = 24;
constexpr int kMaxWts = 256;
constexpr int kMaxFeeds = 8;      // input frames, then frame-ring states
constexpr int kMaxOuts = 4;       // the output, then frame outputs
constexpr int kThreads = 256;     // threads per CTA at most
// CTAs of kThreads an SM must hold by registers: caps a thread at 85
// registers, which every instantiation meets without spilling
constexpr int kMinBlocks = 3;

// op codes: the order of stencil_pipeline.py::OPS
enum Op {
  OP_INPUT = 0, OP_RELAY, OP_CONV, OP_SQUARE, OP_IDENTITY, OP_MAG, OP_PROD,
  OP_NMS, OP_THRESH, OP_UNSHARP, OP_XCORR, OP_DENOISE_COMB, OP_HARRIS_RESP,
  OP_TAP, OP_STMEAN, OP_FRAME_DIFF, OP_BG_SUBTRACT, OP_EXPR
};

// stage bodies: the order of stencil_pipeline.py::KINDS
enum Kind {
  K_GENERIC = 0, K_FEED, K_POINT, K_CONV_1x5, K_CONV_5x1, K_CONV_1x3,
  K_CONV_3x1, K_CONV_3x3, K_NMS_3x3, K_XCORR_18, K_STMEAN_4, K_STMEAN_8,
  K_STMEAN_333, K_EXPR
};

// header fields
// H_NCOLS: columns a CTA computes (a multiple of 32); H_PAD: zero columns
// left of them in every ring row, H_PITCH = H_PAD + H_NCOLS floats a
// ring row; H_OSTAGE, H_SLOTS: offsets (floats) of the output block and
// the ring-row tables in shared memory; H_NRINGS: rings; H_VEC: 16-byte
// vector I/O; H_THREADS: threads per CTA; H_OSYNC: a barrier after the
// output store (a level-0 final stage). H_DEPTH is the prefetch depth,
// H_POISON fills the feed rings' grown slots with NaN first, H_EXPR marks
// a program with an expression stage (it launches from its own library).
enum Hdr {
  H_NSTAGES = 0, H_R, H_H, H_W, H_STRIP_W, H_HALO_LEFT, H_NCOLS, H_BAND_H,
  H_HALO_UP, H_SMEM_BYTES, H_TEMPORAL, H_DEPTH, H_POISON, H_PAD, H_PITCH,
  H_OSTAGE, H_SLOTS, H_NRINGS, H_VEC, H_THREADS, H_OSYNC, H_EXPR
};

// stage fields; S_SRC, S_ST, S_SH and S_SW each hold up to 3 operands.
// S_FEED is an input's feed (or, for a tap, its producer's input feed,
// -1 for an internal producer); S_STATE and S_TAPJ locate a tap's
// frame-ring state and its frames back; S_FOUT is a frame output or -1;
// S_LEAD, at depth >= 2, the rows of a feed's ring that copies fill
// before anything reads them (all but the zero tail above rlo), else 0;
// S_KIND the body that runs the stage; S_SYNC 1 where a barrier follows.
// An expression stage keeps the id of its generated body in S_XID, a
// field only feeds use otherwise.
enum Field {
  S_OP = 0, S_RING, S_FINAL, S_FEED, S_NSRC, S_WOFF, S_FOUT, S_STATE,
  S_TAPJ, S_SRC = 9, S_ST = 12, S_SH = 15, S_SW = 18, S_LEAD = 21,
  S_KIND = 22, S_SYNC = 23, S_XID = S_FEED
};

struct Program {
  int hdr[kHdr];
  int st[kMaxStages][kStageInts];
  int ring[kMaxRings][2];        // {offset in floats, rows}
  float wts[kMaxWts];
};

struct Feeds {
  const float* p[kMaxFeeds];
};

struct Outs {
  float* p[kMaxOuts];
};

#ifndef STENCIL_HOST_SHIM
// 4-byte asynchronous copy from device to shared memory; ok == false
// reads nothing and writes zero (src-size 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// 16-byte asynchronous copy (both addresses 16-byte aligned); ok ==
// false writes zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most min(n, 7) of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}
#endif

// What every stage body of one CTA and row group needs.
struct Ctx {
  const Program* P;
  const Feeds* F;
  const Outs* O;
  float* sm;
  const int* slots;   // ring -> slot holding row row0 (this row group)
  int R, h, w, ncols, pitch, pad, tid, nt;
  int x0, x1, cbase, y0, y1, rlo, row0, t;
  size_t hw, frame;
  bool vec;
  // (row, 4-column item) walk of an R x ncols block for vector I/O:
  // this thread's first item and its stride, divided once per CTA
  int qi0, qq0, qdi, qdq, nq;
};

// The ring slot of row row0 - back (back < the ring's rows).
__device__ __forceinline__ int slot_of_row(const Ctx& c, int ring,
                                           int back) {
  const int s = c.slots[ring] - back;
  return s < 0 ? s + c.P->ring[ring][1] : s;
}

// Walks one ring's rows from some row down, one compare a row. Offsets
// are float indices into shared memory (32-bit, not pointers).
struct Cursor {
  int base;   // ring start, pad columns skipped
  int slot, rows;
  __device__ __forceinline__ void next() {
    slot = slot + 1 == rows ? 0 : slot + 1;
  }
};

__device__ __forceinline__ Cursor cursor(const Ctx& c, int ring, int back) {
  Cursor k;
  k.base = c.P->ring[ring][0] + c.pad;
  k.rows = c.P->ring[ring][1];
  k.slot = slot_of_row(c, ring, back);
  return k;
}

// The cursor's current row, at the CTA's first column.
__device__ __forceinline__ const float* row(const Ctx& c, const Cursor& k) {
  return c.sm + k.base + k.slot * c.pitch;
}

// An SH x SW window of one column in registers: v[dy][dx] is pixel
// (row - SH + 1 + dy, col - SW + 1 + dx) of the producer while output
// row `row` is computed.
template <int SH, int SW>
struct Window {
  float v[SH][SW];
  __device__ __forceinline__ void load(const Ctx& c, int dy,
                                       const Cursor& k, int lc) {
    const float* r = row(c, k) + lc - (SW - 1);
#pragma unroll
    for (int dx = 0; dx < SW; ++dx) v[dy][dx] = r[dx];
  }
  // rows row0 - SH + 1 .. row0 - 1; k starts at row0 - SH + 1
  __device__ __forceinline__ void init(const Ctx& c, Cursor& k, int lc) {
#pragma unroll
    for (int dy = 1; dy < SH; ++dy) {
      load(c, dy, k, lc);
      k.next();
    }
  }
  __device__ __forceinline__ void push(const Ctx& c, Cursor& k, int lc) {
#pragma unroll
    for (int dy = 0; dy + 1 < SH; ++dy)
#pragma unroll
      for (int dx = 0; dx < SW; ++dx) v[dy][dx] = v[dy + 1][dx];
    load(c, SH - 1, k, lc);
    k.next();
  }
};

// Where one column's values of a stage go: its ring (0 at frame column
// < 0), the output block (the final stage), a frame output.
struct Sink {
  int ring;        // the column in the ring (float index), or -1
  int slot, rows;
  int out;         // the column in the output block, or -1
  float* fout;     // the column of the frame output in device memory
  bool zero, fcol;
  __device__ __forceinline__ void put(const Ctx& c, int i, float v) {
    if (ring >= 0) {
      c.sm[ring + slot * c.pitch] = zero ? 0.f : v;
      slot = slot + 1 == rows ? 0 : slot + 1;
    }
    if (out >= 0) c.sm[out + i * c.ncols] = v;
    if (fout) {
      const int r = c.row0 + i;
      if (fcol && r >= c.y0 && r < c.y1)
        fout[static_cast<size_t>(r) * c.w] = v;
    }
  }
};

template <bool kTemporal>
__device__ __forceinline__ Sink sink(const Ctx& c, const int* S, int lc) {
  Sink k;
  const int col = c.cbase + lc;
  const int ring = S[S_RING];
  k.ring = -1;
  k.slot = 0;
  k.rows = 1;
  if (ring >= 0) {
    k.ring = c.P->ring[ring][0] + c.pad + lc;
    k.rows = c.P->ring[ring][1];
    k.slot = slot_of_row(c, ring, 0);
  }
  k.out = S[S_FINAL] ? c.P->hdr[H_OSTAGE] + lc : -1;
  k.fout = kTemporal && S[S_FOUT] >= 0
      ? c.O->p[S[S_FOUT]] + c.frame + col : nullptr;
  k.zero = col < 0;
  k.fcol = col >= c.x0 && col < c.x1;
  return k;
}

// ----------------------------------------------------------------- feeds
// The frame in device memory that a feed stage reads: an input's frame,
// or a tap j of frame b: launch frame b - j, or state slot j - b - 1
// (newest first) when that frame precedes the launch.
__device__ __forceinline__ const float* feed_frame(const Ctx& c,
                                                   const int* S) {
  const int b = blockIdx.z, j = S[S_TAPJ];
  if (S[S_OP] != OP_TAP) return c.F->p[S[S_FEED]] + c.frame;
  return b >= j ? c.F->p[S[S_FEED]] + (b - j) * c.hw
                : c.F->p[S[S_STATE]] + (j - b - 1) * c.hw;
}

// Rows r0 .. r0 + R - 1 of a feed's frame src, zero outside the frame,
// by asynchronous copies into its ring from slot s0 on (rb: the ring at
// the CTA's first column, or null) and into the output block (ob, or
// null). Where H_VEC holds, threads take (row, 4-column) items of 16
// bytes; else each thread takes its columns, every row, 4 bytes a copy.
__device__ __forceinline__ void copy_rows(const Ctx& c, const float* src,
                                          int r0, float* rb, int rows,
                                          int s0, float* ob) {
  if (c.vec) {
    // float4 items; the strip, its halo and w are multiples of 4, so an
    // item lies wholly inside or outside the frame
    int i = c.qi0, q = c.qq0;
    while (i < c.R) {
      const int row = r0 + i, col = c.cbase + 4 * q;
      const bool ok = row < c.h && col >= 0 && col < c.w;
      const float* px = ok ? src + static_cast<size_t>(row) * c.w + col
                           : src;
      if (rb) {
        int s = s0 + i;
        if (s >= rows) s -= rows;
        cp_async16(rb + s * c.pitch + 4 * q, px, ok);
      }
      if (ob) cp_async16(ob + i * c.ncols + 4 * q, px, ok);
      i += c.qdi;
      q += c.qdq;
      if (q >= c.nq) {
        q -= c.nq;
        ++i;
      }
    }
    return;
  }
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    const int col = c.cbase + lc;
    const bool inside = col >= 0 && col < c.w;
    int s = s0;
    for (int i = 0; i < c.R; ++i) {
      const int row = r0 + i;
      const bool ok = inside && row < c.h;
      const float* px = ok ? src + static_cast<size_t>(row) * c.w + col
                           : src;
      if (rb) {
        cp_async4(rb + s * c.pitch + lc, px, ok);
        s = s + 1 == rows ? 0 : s + 1;
      }
      if (ob) cp_async4(ob + i * c.ncols + lc, px, ok);
    }
  }
}

// The R rows of a ring from slot s0 on into the output block, by the
// walk of copy_rows, so each thread moves the elements it copied.
__device__ __forceinline__ void move_rows(const Ctx& c, const float* rb,
                                          int rows, int s0, float* ob) {
  if (c.vec) {
    int i = c.qi0, q = c.qq0;
    while (i < c.R) {
      int s = s0 + i;
      if (s >= rows) s -= rows;
      *reinterpret_cast<float4*>(ob + i * c.ncols + 4 * q) =
          *reinterpret_cast<const float4*>(rb + s * c.pitch + 4 * q);
      i += c.qdi;
      q += c.qdq;
      if (q >= c.nq) {
        q -= c.nq;
        ++i;
      }
    }
    return;
  }
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    int s = s0;
    for (int i = 0; i < c.R; ++i) {
      ob[i * c.ncols + lc] = rb[s * c.pitch + lc];
      s = s + 1 == rows ? 0 : s + 1;
    }
  }
}

// A feed stage: rows row0 .. row0 + R - 1 of its frame into its ring
// (and the output block, if the output reads it), zero outside the frame.
// At depth 1 the rows arrive by asynchronous copies straight into the
// ring, so every feed of the level has its loads in flight at once; the
// level's barrier waits for them. At depth >= 2 they were copied d - 1
// row groups ahead (the kernel's issue), so only a final feed has work:
// the move from its ring to the output block.
template <bool kTemporal, bool kPrefetch>
__device__ __forceinline__ void stage_feed(const Ctx& c, const int* S) {
  if (!kTemporal && S[S_OP] == OP_TAP) return;
  if (kPrefetch && !S[S_FINAL]) return;
  const int ring = S[S_RING];
  float* rb = ring >= 0 ? c.sm + c.P->ring[ring][0] + c.pad : nullptr;
  const int rows = ring >= 0 ? c.P->ring[ring][1] : 1;
  const int s0 = ring >= 0 ? slot_of_row(c, ring, 0) : 0;
  float* ob = S[S_FINAL] ? c.sm + c.P->hdr[H_OSTAGE] : nullptr;
  if constexpr (kPrefetch) {
    move_rows(c, rb, rows, s0, ob);   // every feed has a ring at d >= 2
    return;
  }
  copy_rows(c, feed_frame(c, S), c.row0, rb, rows, s0, ob);
}

// ------------------------------------------------------------ pointwise
// max and min that pass a NaN on, as torch.maximum, amax and clamp and
// the reference's jnp.max and jnp.clip do (fmaxf / fminf return the other
// operand). On the card one instruction, PTX max.NaN / min.NaN (sm_80+),
// whose NaN is the canonical one (0x7fffffff) rather than the operand's;
// the host rehearsal takes the same rule as a select.
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
#else
  return a != a ? a : b != b ? b : fmaxf(a, b);
#endif
}
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
#else
  return a != a ? a : b != b ? b : fminf(a, b);
#endif
}

template <int OP> struct Arity { static constexpr int n = 1; };
template <> struct Arity<OP_MAG> { static constexpr int n = 2; };
template <> struct Arity<OP_PROD> { static constexpr int n = 2; };
template <> struct Arity<OP_UNSHARP> { static constexpr int n = 2; };
template <> struct Arity<OP_BG_SUBTRACT> { static constexpr int n = 2; };
template <> struct Arity<OP_FRAME_DIFF> { static constexpr int n = 2; };
template <> struct Arity<OP_DENOISE_COMB> { static constexpr int n = 3; };

// One pixel of a pointwise op from its operands' values a[] and its
// constant k.
template <int OP>
__device__ __forceinline__ float point(const float* a, float k) {
  if constexpr (OP == OP_SQUARE) {
    return __fmul_rn(a[0], a[0]);
  } else if constexpr (OP == OP_MAG) {
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]),
                                          __fmul_rn(a[1], a[1])), k));
  } else if constexpr (OP == OP_PROD) {
    return __fmul_rn(a[0], a[1]);
  } else if constexpr (OP == OP_THRESH) {
    return a[0] > k ? a[0] : 0.f;
  } else if constexpr (OP == OP_UNSHARP) {
    return __fadd_rn(a[0], __fmul_rn(k, __fsub_rn(a[0], a[1])));
  } else if constexpr (OP == OP_DENOISE_COMB) {
    const float e = min_nan(max_nan(fabsf(a[2]), 0.f), 1.f);
    return __fadd_rn(__fmul_rn(e, a[0]), __fmul_rn(__fsub_rn(1.f, e), a[1]));
  } else if constexpr (OP == OP_HARRIS_RESP) {
    return __fsub_rn(a[0], __fmul_rn(__fmul_rn(k, a[0]), a[0]));
  } else if constexpr (OP == OP_BG_SUBTRACT) {
    const float d = fabsf(__fsub_rn(a[0], a[1]));
    return d > k ? d : 0.f;
  } else if constexpr (OP == OP_FRAME_DIFF) {
    // a[0]: the producer one frame back, a[1]: its current frame
    return fabsf(__fsub_rn(a[1], a[0]));
  } else {  // relay, identity
    return a[0];
  }
}

// A pointwise op on 1x1 operands; frame_diff reads time indices 0 and 1
// of its one temporal operand.
template <bool kTemporal, int OP>
__device__ __forceinline__ void stage_point(const Ctx& c, const int* S) {
  constexpr int N = Arity<OP>::n;
  const float k = c.P->wts[S[S_WOFF]];
  int rings[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    rings[j] = OP == OP_FRAME_DIFF ? S[S_SRC] + j : S[S_SRC + j];
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    Sink out = sink<kTemporal>(c, S, lc);
    Cursor cu[N];
#pragma unroll
    for (int j = 0; j < N; ++j) cu[j] = cursor(c, rings[j], 0);
    for (int i = 0; i < c.R; ++i) {
      float a[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a[j] = row(c, cu[j])[lc];
        cu[j].next();
      }
      out.put(c, i, point<OP>(a, k));
    }
  }
}

// -------------------------------------------------------------- windows
// conv: the first product, then acc + w * x, dy-major then dx
template <bool kTemporal, int SH, int SW>
__device__ __forceinline__ void stage_conv(const Ctx& c, const int* S) {
  float wr[SH * SW];
#pragma unroll
  for (int k = 0; k < SH * SW; ++k) wr[k] = c.P->wts[S[S_WOFF] + k];
  const int ring = S[S_SRC];
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    Sink out = sink<kTemporal>(c, S, lc);
    Cursor cu = cursor(c, ring, SH - 1);
    Window<SH, SW> win;
    win.init(c, cu, lc);
    for (int i = 0; i < c.R; ++i) {
      win.push(c, cu, lc);
      float v = __fmul_rn(wr[0], win.v[0][0]);
#pragma unroll
      for (int k = 1; k < SH * SW; ++k)
        v = __fadd_rn(v, __fmul_rn(wr[k], win.v[k / SW][k % SW]));
      out.put(c, i, v);
    }
  }
}

// nms over 3x3: centre [-2, -2], the max over every cell (from [0, 0])
template <bool kTemporal>
__device__ __forceinline__ void stage_nms3(const Ctx& c, const int* S) {
  const int ring = S[S_SRC];
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    Sink out = sink<kTemporal>(c, S, lc);
    Cursor cu = cursor(c, ring, 2);
    Window<3, 3> win;
    win.init(c, cu, lc);
    for (int i = 0; i < c.R; ++i) {
      win.push(c, cu, lc);
      const float ctr = win.v[1][1];
      float m = win.v[0][0];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = max_nan(m, win.v[dy][dx]);
      out.put(c, i, ctr >= m ? ctr : 0.f);
    }
  }
}

// xcorr: an 18-tall column correlation minus the centre operand
template <bool kTemporal>
__device__ __forceinline__ void stage_xcorr18(const Ctx& c, const int* S) {
  constexpr int SH = 18;
  float wr[SH];
#pragma unroll
  for (int k = 0; k < SH; ++k) wr[k] = c.P->wts[S[S_WOFF] + k];
  const int tall = S[S_SRC], ctr = S[S_SRC + 1];
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    Sink out = sink<kTemporal>(c, S, lc);
    Cursor cu = cursor(c, tall, SH - 1);
    Cursor cc = cursor(c, ctr, 0);
    Window<SH, 1> win;
    win.init(c, cu, lc);
    for (int i = 0; i < c.R; ++i) {
      win.push(c, cu, lc);
      float v = __fmul_rn(wr[0], win.v[0][0]);
#pragma unroll
      for (int dy = 1; dy < SH; ++dy)
        v = __fadd_rn(v, __fmul_rn(wr[dy], win.v[dy][0]));
      v = __fsub_rn(v, row(c, cc)[lc]);
      cc.next();
      out.put(c, i, v);
    }
  }
}

// stmean over an ST x SH x SW box: the sum dt-major, then dy, then dx,
// then one multiply by 1 / (ST * SH * SW); time index dt is ring first + dt
template <int ST, int SH, int SW>
__device__ __forceinline__ void stage_stmean(const Ctx& c, const int* S) {
  const float k = c.P->wts[S[S_WOFF]];
  const int first = S[S_SRC];
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    Sink out = sink<true>(c, S, lc);
    Cursor cu[ST];
    Window<SH, SW> win[ST];
#pragma unroll
    for (int dt = 0; dt < ST; ++dt) {
      cu[dt] = cursor(c, first + dt, SH - 1);
      win[dt].init(c, cu[dt], lc);
    }
    for (int i = 0; i < c.R; ++i) {
#pragma unroll
      for (int dt = 0; dt < ST; ++dt) win[dt].push(c, cu[dt], lc);
      float v = win[0].v[0][0];
#pragma unroll
      for (int n = 1; n < ST * SH * SW; ++n)
        v = __fadd_rn(v, win[n / (SH * SW)].v[n / SW % SH][n % SW]);
      out.put(c, i, __fmul_rn(v, k));
    }
  }
}

// -------------------------------------------------------------- generic
// Element (dt, dy, dx) of operand j's window at row i of the row group and
// column lc: pixel (row - sh + 1 + dy, col - sw + 1 + dx) of ring
// S_SRC[j] + dt.
__device__ __forceinline__ float ring_tap(const Ctx& c, const int* S, int i,
                                          int lc, int j, int dt, int dy,
                                          int dx) {
  const int ring = S[S_SRC + j] + dt;
  const int rows = c.P->ring[ring][1];
  // i + dy - (sh - 1) lies in [-(rows - 1), rows - 1]
  int s = c.slots[ring] + i + dy - (S[S_SH + j] - 1);
  s = s < 0 ? s + rows : (s >= rows ? s - rows : s);
  return c.sm[c.P->ring[ring][0] + c.pad + s * c.pitch + lc
              - (S[S_SW + j] - 1) + dx];
}

// Any op and window shape: every tap read from shared memory.
template <bool kTemporal>
__device__ __forceinline__ void stage_generic(const Ctx& c, const int* S) {
  const int op = S[S_OP];
  const float* wt = c.P->wts + S[S_WOFF];
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    Sink out = sink<kTemporal>(c, S, lc);
    for (int i = 0; i < c.R; ++i) {
      auto tap3 = [&](int j, int dt, int dy, int dx) -> float {
        return ring_tap(c, S, i, lc, j, dt, dy, dx);
      };
      auto tap = [&](int j, int dy, int dx) -> float {
        return tap3(j, 0, dy, dx);
      };
      float v = 0.f;
      switch (op) {
        case OP_STMEAN: {
          if (!kTemporal) break;
          const int st = S[S_ST], sh = S[S_SH], sw = S[S_SW];
          int k = 0;
          for (int dt = 0; dt < st; ++dt)
            for (int dy = 0; dy < sh; ++dy)
              for (int dx = 0; dx < sw; ++dx, ++k) {
                const float t = tap3(0, dt, dy, dx);
                v = k ? __fadd_rn(v, t) : t;
              }
          v = __fmul_rn(v, wt[0]);
          break;
        }
        case OP_FRAME_DIFF:
          if (kTemporal)
            v = fabsf(__fsub_rn(tap3(0, 1, 0, 0), tap3(0, 0, 0, 0)));
          break;
        case OP_BG_SUBTRACT: {
          if (!kTemporal) break;
          const float d = fabsf(__fsub_rn(tap(0, 0, 0), tap(1, 0, 0)));
          v = d > wt[0] ? d : 0.f;
          break;
        }
        case OP_RELAY:
        case OP_IDENTITY:
          v = tap(0, 0, 0);
          break;
        case OP_CONV: {
          const int sh = S[S_SH], sw = S[S_SW];
          int k = 0;
          for (int dy = 0; dy < sh; ++dy)
            for (int dx = 0; dx < sw; ++dx, ++k) {
              const float t = __fmul_rn(wt[k], tap(0, dy, dx));
              v = k ? __fadd_rn(v, t) : t;
            }
          break;
        }
        case OP_SQUARE: {
          const float a = tap(0, 0, 0);
          v = __fmul_rn(a, a);
          break;
        }
        case OP_MAG: {
          const float a = tap(0, 0, 0), b = tap(1, 0, 0);
          v = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a),
                                             __fmul_rn(b, b)), wt[0]));
          break;
        }
        case OP_PROD:
          v = __fmul_rn(tap(0, 0, 0), tap(1, 0, 0));
          break;
        case OP_NMS: {
          // centre [-2, -2] when sw >= 2, else [-1, -1]; the max runs
          // over the zero-padded cells too
          const int sh = S[S_SH], sw = S[S_SW];
          const float ctr = sw >= 2 ? tap(0, sh - 2, sw - 2)
                                    : tap(0, sh - 1, sw - 1);
          float m = tap(0, 0, 0);
          for (int dy = 0; dy < sh; ++dy)
            for (int dx = 0; dx < sw; ++dx) m = max_nan(m, tap(0, dy, dx));
          v = ctr >= m ? ctr : 0.f;
          break;
        }
        case OP_THRESH: {
          const float a = tap(0, 0, 0);
          v = a > wt[0] ? a : 0.f;
          break;
        }
        case OP_UNSHARP: {
          const float o = tap(0, 0, 0), b = tap(1, 0, 0);
          v = __fadd_rn(o, __fmul_rn(wt[0], __fsub_rn(o, b)));
          break;
        }
        case OP_XCORR: {
          const int sh = S[S_SH];
          for (int dy = 0; dy < sh; ++dy) {
            const float t = __fmul_rn(wt[dy], tap(0, dy, 0));
            v = dy ? __fadd_rn(v, t) : t;
          }
          v = __fsub_rn(v, tap(1, 0, 0));
          break;
        }
        case OP_DENOISE_COMB: {
          const float o = tap(0, 0, 0), b = tap(1, 0, 0), l = tap(2, 0, 0);
          const float e = min_nan(max_nan(fabsf(l), 0.f), 1.f);
          v = __fadd_rn(__fmul_rn(e, o), __fmul_rn(__fsub_rn(1.f, e), b));
          break;
        }
        case OP_HARRIS_RESP: {
          const float a = tap(0, 0, 0);
          v = __fsub_rn(a, __fmul_rn(__fmul_rn(wt[0], a), a));
          break;
        }
      }
      out.put(c, i, v);
    }
  }
}

// ----------------------------------------------------------- expression
// The program's generated stage bodies and stage_generated<kTemporal>(c,
// S), which runs the one whose id is S[S_XID] (a fragment written by
// repro_torch/kernels/expr_codegen.py, named where its library is built).
#ifdef STENCIL_EXPR
#include STENCIL_EXPR
#else
template <bool kTemporal>
__device__ __forceinline__ void stage_generated(const Ctx&, const int*) {}
#endif

template <bool kTemporal>
__device__ __forceinline__ void stage_point_op(const Ctx& c, const int* S) {
  switch (S[S_OP]) {
    case OP_SQUARE: stage_point<kTemporal, OP_SQUARE>(c, S); break;
    case OP_MAG: stage_point<kTemporal, OP_MAG>(c, S); break;
    case OP_PROD: stage_point<kTemporal, OP_PROD>(c, S); break;
    case OP_THRESH: stage_point<kTemporal, OP_THRESH>(c, S); break;
    case OP_UNSHARP: stage_point<kTemporal, OP_UNSHARP>(c, S); break;
    case OP_DENOISE_COMB:
      stage_point<kTemporal, OP_DENOISE_COMB>(c, S);
      break;
    case OP_HARRIS_RESP: stage_point<kTemporal, OP_HARRIS_RESP>(c, S); break;
    case OP_BG_SUBTRACT:
      if constexpr (kTemporal) stage_point<true, OP_BG_SUBTRACT>(c, S);
      break;
    case OP_FRAME_DIFF:
      if constexpr (kTemporal) stage_point<true, OP_FRAME_DIFF>(c, S);
      break;
    default: stage_point<kTemporal, OP_IDENTITY>(c, S); break;
  }
}

// Rows row0 .. row0 + R - 1 of the output block to the output, inside
// the CTA's strip and band.
__device__ __forceinline__ void store_output(const Ctx& c) {
  const float* ob = c.sm + c.P->hdr[H_OSTAGE];
  float* out = c.O->p[0] + c.frame;
  if (c.vec) {
    int i = c.qi0, q = c.qq0;
    while (i < c.R) {
      const int row = c.row0 + i, col = c.cbase + 4 * q;
      if (row >= c.y0 && row < c.y1 && col >= c.x0 && col < c.x1)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * c.w
                                   + col) =
            *reinterpret_cast<const float4*>(ob + i * c.ncols + 4 * q);
      i += c.qdi;
      q += c.qdq;
      if (q >= c.nq) {
        q -= c.nq;
        ++i;
      }
    }
    return;
  }
  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {
    const int col = c.cbase + lc;
    if (col < c.x0 || col >= c.x1) continue;
    for (int i = 0; i < c.R; ++i) {
      const int row = c.row0 + i;
      if (row >= c.y0 && row < c.y1)
        out[static_cast<size_t>(row) * c.w + col] = ob[i * c.ncols + lc];
    }
  }
}

// kTemporal: the instantiation that also runs history taps, the temporal
// ops and frame outputs. Spatial programs launch the other one, whose code
// is the spatial kernel's alone (the temporal cases compile to nothing).
// kPrefetch: feeds are copied into their grown rings d - 1 row groups
// ahead (prefetch depth d >= 2); without it the feed stages copy their
// row group's rows at level 0 and wait for them. Expression stages run
// where the STENCIL_EXPR hook holds the program's generated bodies.
template <bool kTemporal, bool kPrefetch>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stencil_pipeline_kernel(const __grid_constant__ Program P,
                        const __grid_constant__ Feeds F,
                        const __grid_constant__ Outs O) {
  extern __shared__ float smem[];
  Ctx c;
  c.P = &P;
  c.F = &F;
  c.O = &O;
  c.sm = smem;
  c.R = P.hdr[H_R];
  c.h = P.hdr[H_H];
  c.w = P.hdr[H_W];
  c.ncols = P.hdr[H_NCOLS];
  c.pitch = P.hdr[H_PITCH];
  c.pad = P.hdr[H_PAD];
  c.tid = threadIdx.x;
  c.nt = blockDim.x;
  c.vec = P.hdr[H_VEC] != 0;
  const int n_stages = P.hdr[H_NSTAGES];
  const int n_rings = P.hdr[H_NRINGS];
  // output columns [x0, x1), computed columns [cbase, cbase + ncols)
  c.x0 = blockIdx.x * P.hdr[H_STRIP_W];
  c.x1 = min(c.x0 + P.hdr[H_STRIP_W], c.w);
  c.cbase = c.x0 - P.hdr[H_HALO_LEFT];
  // output rows [y0, y1), computed from row rlo on
  c.y0 = blockIdx.y * P.hdr[H_BAND_H];
  c.y1 = min(c.y0 + P.hdr[H_BAND_H], c.h);
  c.rlo = max(c.y0 - P.hdr[H_HALO_UP], 0);
  c.hw = static_cast<size_t>(c.h) * c.w;
  c.frame = blockIdx.z * c.hw;
  // the one division of the vector walk: item tid of nq per row
  c.nq = c.ncols / 4;
  c.qi0 = c.tid / c.nq;
  c.qq0 = c.tid - c.qi0 * c.nq;
  c.qdi = c.nt / c.nq;
  c.qdq = c.nt - c.qdi * c.nq;
  // two tables of each ring's slot of the row group's first row, by
  // parity of the row group: table t & 1 is read during row group t
  // while the next one is written
  int* slots = reinterpret_cast<int*>(smem + P.hdr[H_SLOTS]);

  // zero rings (their pad columns and the rows above rlo stay zero)
  {
    const int n4 = P.hdr[H_OSTAGE] / 4;
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = c.tid; i < n4; i += c.nt)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = c.tid; i < n_rings; i += c.nt) slots[i] = 0;
  }

  // prefetch: the copies of step u (none past the band's last step) into
  // the feed rings, row rlo + u * R at slot table[ring] + ahead * R, with
  // the table of a row group u - ahead, committed as one group. Feeds are
  // the level-0 stages, so they come first.
  const int depth = kPrefetch ? P.hdr[H_DEPTH] : 1;
  const int n_steps = (c.y1 - c.rlo + c.R - 1) / c.R;
  auto issue = [&](int u, const int* table, int ahead) {
    for (int s = 0; u < n_steps && s < n_stages; ++s) {
      const int* S = P.st[s];
      if (S[S_KIND] != K_FEED) break;
      if (!kTemporal && S[S_OP] == OP_TAP) continue;
      const int ring = S[S_RING], rows = P.ring[ring][1];
      int s0 = table[ring] + ahead * c.R;
      if (s0 >= rows) s0 -= rows;
      copy_rows(c, feed_frame(c, S), c.rlo + u * c.R,
                smem + P.ring[ring][0] + c.pad, rows, s0, nullptr);
    }
    cp_async_commit();
  };
  if constexpr (kPrefetch) {
    // the copies land on zeroed rows and read the zeroed row table
    __syncthreads();
    if (P.hdr[H_POISON]) {
      // debug: the slots copies fill before any read (not the zero tail,
      // not the pad columns) hold NaN, so a read that overtakes its copy
      // shows; another thread's copy may land on an element this one
      // poisons, hence the barrier
      for (int s = 0; s < n_stages && P.st[s][S_KIND] == K_FEED; ++s) {
        const int n = P.st[s][S_LEAD] * c.ncols;
        float* rb = smem + P.ring[P.st[s][S_RING]][0] + c.pad;
        for (int i = c.tid; i < n; i += c.nt)
          rb[i / c.ncols * c.pitch + i % c.ncols] =
              __int_as_float(0x7fc00000);
      }
      __syncthreads();
    }
    for (int u = 0; u < depth; ++u) issue(u, slots, u);   // table 0
  }
  __syncthreads();

  c.t = 0;
  for (c.row0 = c.rlo; c.row0 < c.y1; c.row0 += c.R, ++c.t) {
    const int* cur = slots + (c.t & 1) * kMaxRings;
    c.slots = cur;
    // the next row group's table, read after this row group's barriers
    for (int k = c.tid; k < n_rings; k += c.nt) {
      const int s = cur[k] + c.R, rows = P.ring[k][1];
      slots[((c.t + 1) & 1) * kMaxRings + k] = s >= rows ? s - rows : s;
    }
    // this thread's copies of step t land before the feeds' barrier
    if constexpr (kPrefetch) cp_async_wait(depth - 1);
    for (int s = 0; s < n_stages; ++s) {
      const int* S = P.st[s];
      switch (S[S_KIND]) {
        case K_FEED: stage_feed<kTemporal, kPrefetch>(c, S); break;
        case K_POINT: stage_point_op<kTemporal>(c, S); break;
        case K_CONV_1x5: stage_conv<kTemporal, 1, 5>(c, S); break;
        case K_CONV_5x1: stage_conv<kTemporal, 5, 1>(c, S); break;
        case K_CONV_1x3: stage_conv<kTemporal, 1, 3>(c, S); break;
        case K_CONV_3x1: stage_conv<kTemporal, 3, 1>(c, S); break;
        case K_CONV_3x3: stage_conv<kTemporal, 3, 3>(c, S); break;
        case K_NMS_3x3: stage_nms3<kTemporal>(c, S); break;
        case K_XCORR_18: stage_xcorr18<kTemporal>(c, S); break;
        case K_STMEAN_4:
          if constexpr (kTemporal) stage_stmean<4, 1, 1>(c, S);
          break;
        case K_STMEAN_8:
          if constexpr (kTemporal) stage_stmean<8, 1, 1>(c, S);
          break;
        case K_STMEAN_333:
          if constexpr (kTemporal) stage_stmean<3, 3, 3>(c, S);
          break;
        case K_EXPR: stage_generated<kTemporal>(c, S); break;
        default: stage_generic<kTemporal>(c, S); break;
      }
      // the next level reads this level's rings; after the last level
      // the next row group may overwrite every ring row read here. Level
      // 0 (the feeds) first waits for its copies at depth 1.
      if (S[S_SYNC]) {
        if (!kPrefetch && S[S_KIND] == K_FEED) cp_async_wait_all();
        __syncthreads();
      }
    }
    store_output(c);
    if (P.hdr[H_OSYNC]) __syncthreads();
    // no stage reads step t's rows any more: refill with step t + depth,
    // from the next row group's table (this one's is rewritten at step
    // t + 1, while a slower thread may still be here)
    if constexpr (kPrefetch)
      issue(c.t + depth, slots + ((c.t + 1) & 1) * kMaxRings, depth - 1);
  }
}

using Kernel = void (*)(Program, Feeds, Outs);

#ifdef STENCIL_EXPR
// A program's own library: the one instantiation its launches take.
Kernel pick_kernel(int temporal, int prefetch, int expr) {
  if (!expr || temporal != STENCIL_EXPR_TEMPORAL
      || prefetch != STENCIL_EXPR_PREFETCH)
    return nullptr;
  return stencil_pipeline_kernel<STENCIL_EXPR_TEMPORAL != 0,
                                 STENCIL_EXPR_PREFETCH != 0>;
}
#else
// The shared library: the four instantiations of payload programs.
Kernel pick_kernel(int temporal, int prefetch, int expr) {
  if (expr) return nullptr;
  if (prefetch)
    return temporal ? stencil_pipeline_kernel<true, true>
                    : stencil_pipeline_kernel<false, true>;
  return temporal ? stencil_pipeline_kernel<true, false>
                  : stencil_pipeline_kernel<false, false>;
}
#endif

}  // namespace

// table: kHdr + kMaxStages * kStageInts + kMaxRings * 2 ints; wts: kMaxWts
// floats; feeds: kMaxFeeds device pointers (inputs, then frame-ring
// states); outs: kMaxOuts (the output, then frame outputs). Vector I/O
// needs every pointer 16-byte aligned; the launch falls back to scalar
// I/O otherwise. Launches on ``stream`` and returns the cudaError_t of
// the launch (0 on success; cudaErrorInvalidDeviceFunction for a program
// this library does not hold).
extern "C" int stencil_pipeline_launch(const int* table, const float* wts,
                                       const void* const* feeds,
                                       void* const* outs,
                                       int grid_x, int grid_y, int grid_z,
                                       void* stream) {
  Program P;
  memcpy(P.hdr, table, sizeof(P.hdr));
  memcpy(P.st, table + kHdr, sizeof(P.st));
  memcpy(P.ring, table + kHdr + kMaxStages * kStageInts, sizeof(P.ring));
  memcpy(P.wts, wts, sizeof(P.wts));
  Feeds F;
  uintptr_t bits = 0;
  for (int i = 0; i < kMaxFeeds; ++i) {
    F.p[i] = static_cast<const float*>(feeds[i]);
    bits |= reinterpret_cast<uintptr_t>(feeds[i]);
  }
  Outs O;
  for (int i = 0; i < kMaxOuts; ++i) {
    O.p[i] = static_cast<float*>(outs[i]);
    bits |= reinterpret_cast<uintptr_t>(outs[i]);
  }
  if (bits & 15) P.hdr[H_VEC] = 0;
  const int smem = P.hdr[H_SMEM_BYTES];
  const Kernel kernel = pick_kernel(P.hdr[H_TEMPORAL], P.hdr[H_DEPTH] > 1,
                                    P.hdr[H_EXPR]);
  if (kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidDeviceFunction);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, grid_y, grid_z), P.hdr[H_THREADS], smem,
           static_cast<cudaStream_t>(stream)>>>(P, F, O);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stencil_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// CTAs of the kernel (the temporal instantiation when ``temporal``, the
// prefetch one when ``prefetch``, a program's own when ``expr``) that
// fit on one SM at ``threads`` threads and ``smem_bytes`` of dynamic
// shared memory each, written to ``*blocks``; returns the cudaError_t.
extern "C" int stencil_pipeline_blocks_per_sm(int smem_bytes, int temporal,
                                              int prefetch, int expr,
                                              int threads, int* blocks) {
  const Kernel kernel = pick_kernel(temporal, prefetch, expr);
  if (kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidDeviceFunction);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem_bytes));
}

// Registers a thread and local memory bytes a thread of the
// instantiation pick_kernel(temporal, prefetch, expr) returns, as the
// loaded module holds it (cudaFuncGetAttributes), written to *registers
// and *local_bytes; returns the cudaError_t. Local memory is where ptxas
// spills, so 0 bytes means no spills.
extern "C" int stencil_pipeline_attributes(int temporal, int prefetch,
                                           int expr, int* registers,
                                           int* local_bytes) {
  const Kernel kernel = pick_kernel(temporal, prefetch, expr);
  if (kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidDeviceFunction);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

#ifndef STENCIL_EXPR
// ------------------------------------------------------------ unorm8
// The decode of unorm8 frames (kernels/unorm8.py): 8-bit unsigned-
// normalised pixels, the byte v in 0..255 standing for the float32 v / 255.
// It replaces no TPU kernel (the JAX package takes float frames only): a
// host frame in this format crosses the link at one byte a pixel and is
// decoded here into the float32 batch the stencil kernel reads. It sits in
// the shared library, which serving loads anyway, so it costs no build of
// its own; a program's own library (STENCIL_EXPR) leaves it out.
//
// Each value is read from a 256-entry table the host computes once
// (np.float32(v) / np.float32(255), the correctly rounded quotient), held
// in shared memory: no division on the card decides a bit. What bounds it:
// one byte read and four written a pixel, so device-memory bytes. Four
// pixels a thread a step, one uchar4 load and one float4 store, where both
// pointers allow it (the engines' buffers always do); the pixels after the
// last whole four, and misaligned pointers, go one at a time. A grid-stride
// loop over at most a few thousand CTAs loads the table once a CTA.
namespace {

constexpr int kDecodeThreads = 256;     // one table entry a thread

__global__ void __launch_bounds__(kDecodeThreads)
unorm8_decode_kernel(const uint8_t* __restrict__ src,
                     float* __restrict__ dst,
                     const float* __restrict__ table, long long n, int vec) {
  __shared__ float lut[256];
  lut[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const long long stride =
      static_cast<long long>(gridDim.x) * kDecodeThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kDecodeThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const uchar4* s4 = reinterpret_cast<const uchar4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long i = first; i < n4; i += stride) {
      const uchar4 v = s4[i];
      d4[i] = make_float4(lut[v.x], lut[v.y], lut[v.z], lut[v.w]);
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride) dst[i] = lut[src[i]];
}

}  // namespace

// Decodes the n bytes at src into the n floats at dst through the 256
// floats at table (all device pointers), on ``stream``, over ``blocks``
// CTAs (n > 0, blocks > 0). Returns the cudaError_t of the launch.
extern "C" int unorm8_decode_launch(const void* src, void* dst,
                                    const void* table, long long n,
                                    int blocks, void* stream) {
  const int vec = ((reinterpret_cast<uintptr_t>(src) & 3)
                   | (reinterpret_cast<uintptr_t>(dst) & 15)) == 0;
  unorm8_decode_kernel<<<blocks, kDecodeThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<float*>(dst),
      static_cast<const float*>(table), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ stage ahead
// The stager of FrameEngine (kernels/stage_ahead.py). Host code only: it
// sits here so that serving loads it with the kernels and it costs no
// build of its own; a program's own library leaves it out.
//
// A ticket is one host frame admitted ahead of its batch. A lead thread
// takes the oldest pending ticket once one of the ring's slots is free and
// hands the frame to a team of threads, which copy it from the caller's
// pageable memory into the slot's page-locked half in chunks, while they
// finish the frame before; the thread that copies its last chunk issues the
// slot's copy to the card on a stream of the stager's own and records the
// slot's `copied` event. The serving thread claims a batch's tickets
// (stager_claim): an issued ticket is gathered from its device slot on the
// caller's stream once `copied` is reached, and one being staged is waited
// for. A pending one goes to the front of the queue and is waited for when
// a slot is free for it, so it waits behind no later frame but the one in
// hand; else it is taken back, for the caller to stage itself. (Taking
// back every pending frame had the caller's staging threads and these
// contend for the cores whenever the lead fell behind.)
// stager_release hands slots back and records each slot's `released`
// event on the caller's stream; the slot's next copy to the card waits
// for it, so a device slot is rewritten only after whatever the caller
// queued before the release (the gather) has run. A page-locked slot is
// rewritten only after its last copy to the card is done (`copied`). The
// calls that wait do so without Python's lock, which ctypes drops, and
// no thread of the stager ever takes it.
// ---- stage ahead: begin
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace stage_ahead {

enum : int { kPending, kStaging, kIssued };   // a ticket's state
enum : int { kTaken = 0, kWaited = 1, kAhead = 2 };   // what a claim found

// rows of row_bytes each, pitch bytes apart at src, copied packed to dst
struct Copy {
  const char* src = nullptr;
  char* dst = nullptr;
  long long rows = 0, row_bytes = 0, pitch = 0;
};

struct Ticket {
  Copy frame;            // dst unset until the ticket has a slot
  int state = kPending;
  int slot = -1;
};

struct Held {                   // a ticket's frame in the team's hands
  long long id = 0, bytes = 0;
  int slot = -1;
};

// One frame in the team's hands: its packed bytes in chunks of kChunk,
// which the team's threads claim one at a time (`next`) and count down as
// they copy them (`left`). `seq` publishes it; a thread that finds no chunk
// left counts itself out (`out`), and once all have, the job may be reused.
struct Job {
  Copy c;
  Held h;
  int chunks = 0;
  std::atomic<int> next{0}, left{0}, out{0};
  std::atomic<long long> seq{-1};
};
constexpr long long kChunk = 256 << 10;
constexpr int kJobs = 2;         // frames in the team's hands at once

struct Stager {
  int device = 0, n_slots = 0, team_size = 1;
  long long slot_bytes = 0;
  char* pinned = nullptr;           // n_slots page-locked slots
  char* dev = nullptr;              // n_slots device slots
  cudaStream_t stream = nullptr;    // the copies to the card
  std::vector<cudaEvent_t> copied, released;
  std::vector<char> has_copied, has_released;

  std::mutex mu;                    // guards the fields down to `error`
  std::condition_variable work;     // the lead: a ticket and a slot, or stop
  std::condition_variable issued;   // a ticket left kStaging
  std::unordered_map<long long, Ticket> tickets;
  std::deque<long long> queue;      // admission order; stale ids skipped
  std::deque<int> free_slots;
  long long next_id = 1;
  bool stop = false;
  int busy = 0;                     // tickets in kStaging
  std::atomic<long long> n_issued{0};   // tickets that left kStaging
  int error = 0;                    // the threads' first CUDA error

  Job jobs[kJobs];                  // frame seq in jobs[seq % kJobs]
  std::mutex team_mu;               // only for blocking on the jobs
  std::condition_variable team_go, team_done;
  std::atomic<bool> team_stop{false};

  std::thread lead;
  std::vector<std::thread> team;
};

// n bytes from src to dst: with SSE2, 64 bytes a step by streaming
// stores, which write around the caches. The slot is read next by the copy
// to the card, not by a core, and a cached store would first read each
// line in: on an H100's host, 7 threads streaming took 0.48-0.49 ms a
// 1080p frame, with memcpy 0.83-1.36.
void copy_bytes(char* dst, const char* src, long long n) {
#if defined(__SSE2__)
  for (; n > 0 && (reinterpret_cast<uintptr_t>(dst) & 15); --n)
    *dst++ = *src++;
  for (; n >= 64; n -= 64, src += 64, dst += 64) {
    const __m128i* a = reinterpret_cast<const __m128i*>(src);
    __m128i* b = reinterpret_cast<__m128i*>(dst);
    const __m128i v0 = _mm_loadu_si128(a), v1 = _mm_loadu_si128(a + 1);
    const __m128i v2 = _mm_loadu_si128(a + 2), v3 = _mm_loadu_si128(a + 3);
    _mm_stream_si128(b, v0);
    _mm_stream_si128(b + 1, v1);
    _mm_stream_si128(b + 2, v2);
    _mm_stream_si128(b + 3, v3);
  }
#endif
  memcpy(dst, src, n);
}

// Streaming stores are ordered by a fence before another thread may act on
// them (here: issue the copy to the card).
void store_fence() {
#if defined(__SSE2__)
  _mm_sfence();
#endif
}

// Poll pred() for up to kSpin before the caller blocks: a thread woken from
// a block starts tens of microseconds late. Kept short: a thread that polls
// holds a core, and the serving thread, the lead and torch's threads want
// some; a preempted step can stall past the busy rule's 2 ms.
constexpr std::chrono::microseconds kSpin(50);

template <class Pred>
bool spin(Pred pred) {
  const auto end = std::chrono::steady_clock::now() + kSpin;
  for (int i = 1;; ++i) {
    if (pred()) return true;
#if defined(__SSE2__)
    _mm_pause();
#else
    std::this_thread::yield();
#endif
    if ((i & 63) == 0 && std::chrono::steady_clock::now() > end) return false;
  }
}

// Bytes [lo, hi) of c's packed bytes.
void copy_range(const Copy& c, long long lo, long long hi) {
  while (lo < hi) {
    const long long r = lo / c.row_bytes, col = lo % c.row_bytes;
    const long long n = hi - lo < c.row_bytes - col ? hi - lo
                                                    : c.row_bytes - col;
    copy_bytes(c.dst + lo, c.src + r * c.pitch + col, n);
    lo += n;
  }
  store_fence();
}

void notify(Stager* s, std::condition_variable& cv) {
  { std::lock_guard<std::mutex> lk(s->team_mu); }   // no lost wake-up
  cv.notify_all();
}

void issue(Stager* s, const Held& h);

// A thread of the team: every frame in turn, as many of its chunks as it
// can claim; the thread that copies a frame's last chunk issues its copy to
// the card.
void team_main(Stager* s) {
  cudaSetDevice(s->device);
  for (long long seq = 0;; ++seq) {
    Job& j = s->jobs[seq % kJobs];
    auto ready = [&] {
      return s->team_stop.load(std::memory_order_acquire)
             || j.seq.load(std::memory_order_acquire) == seq;
    };
    if (!spin(ready)) {
      std::unique_lock<std::mutex> lk(s->team_mu);
      s->team_go.wait(lk, ready);
    }
    if (j.seq.load(std::memory_order_acquire) != seq) return;   // stopped
    const long long total = j.c.rows * j.c.row_bytes;
    for (int k; (k = j.next.fetch_add(1, std::memory_order_relaxed))
                < j.chunks;) {
      copy_range(j.c, k * kChunk, std::min(total, (k + 1) * kChunk));
      if (j.left.fetch_sub(1, std::memory_order_acq_rel) == 1) issue(s, j.h);
    }
    if (j.out.fetch_add(1, std::memory_order_acq_rel) + 1 == s->team_size)
      notify(s, s->team_done);
  }
}

// Hand frame `seq` (c, of ticket h) to the team, once it has left frame
// seq - kJobs. No spin: the lead would take a core from the team.
void publish(Stager* s, const Copy& c, const Held& h, long long seq) {
  Job& j = s->jobs[seq % kJobs];
  {
    std::unique_lock<std::mutex> lk(s->team_mu);
    s->team_done.wait(lk, [&] {
      return j.out.load(std::memory_order_acquire) == s->team_size;
    });
  }
  j.c = c;
  j.h = h;
  j.chunks = static_cast<int>((c.rows * c.row_bytes + kChunk - 1) / kChunk);
  j.next.store(0, std::memory_order_relaxed);
  j.left.store(j.chunks, std::memory_order_relaxed);
  j.out.store(0, std::memory_order_relaxed);
  j.seq.store(seq, std::memory_order_release);
  notify(s, s->team_go);
}

// The ticket of h leaves kStaging: kIssued, or dropped on a CUDA error.
void settle(Stager* s, const Held& h, cudaError_t err) {
  std::lock_guard<std::mutex> lk(s->mu);
  --s->busy;
  s->n_issued.fetch_add(1, std::memory_order_release);
  if (err == cudaSuccess) {
    s->tickets[h.id].state = kIssued;
  } else {
    if (s->error == 0) s->error = static_cast<int>(err);
    s->tickets.erase(h.id);
    s->free_slots.push_back(h.slot);
  }
  s->issued.notify_all();
}

// The ticket of h, copied into its page-locked slot: its copy to the card
// issued once the slot's last gather has run, and the ticket kIssued; on a
// CUDA error the ticket is dropped (a claim then finds it taken back).
void issue(Stager* s, const Held& h) {
  const int slot = h.slot;
  cudaError_t err = cudaSuccess;
  if (s->has_released[slot])
    err = cudaStreamWaitEvent(s->stream, s->released[slot], 0);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(s->dev + slot * s->slot_bytes,
                          s->pinned + slot * s->slot_bytes, h.bytes,
                          cudaMemcpyHostToDevice, s->stream);
  if (err == cudaSuccess) err = cudaEventRecord(s->copied[slot], s->stream);
  s->has_copied[slot] = err == cudaSuccess;
  if (err != cudaSuccess) cudaStreamSynchronize(s->stream);
  settle(s, h, err);
}

// The lead: takes the oldest pending ticket whenever a slot is free, waits
// for the slot's last copy to the card, and hands the frame to the team,
// which has at most kJobs frames in hand.
void lead_main(Stager* s) {
  cudaSetDevice(s->device);
  for (long long seq = 0;;) {
    Held h;
    Copy c;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      for (;;) {
        while (!s->queue.empty()) {
          auto it = s->tickets.find(s->queue.front());
          if (it != s->tickets.end() && it->second.state == kPending) break;
          s->queue.pop_front();
        }
        if (s->stop) return;
        if (!s->queue.empty() && !s->free_slots.empty()) break;
        s->work.wait(lk);
      }
      h.id = s->queue.front();
      s->queue.pop_front();
      h.slot = s->free_slots.front();
      s->free_slots.pop_front();
      Ticket& t = s->tickets[h.id];     // kStaging: erased by no one
      t.state = kStaging;
      t.slot = h.slot;
      ++s->busy;
      c = t.frame;
      c.dst = s->pinned + h.slot * s->slot_bytes;
      h.bytes = c.rows * c.row_bytes;
    }
    // the page-locked slot is rewritten once its last copy is done
    const cudaError_t err = s->has_copied[h.slot]
        ? cudaEventSynchronize(s->copied[h.slot]) : cudaSuccess;
    if (err != cudaSuccess) {
      cudaStreamSynchronize(s->stream);
      settle(s, h, err);
      continue;
    }
    publish(s, c, h, seq++);
  }
}

bool staging(Stager* s, long long id) {
  auto it = s->tickets.find(id);
  return it != s->tickets.end() && it->second.state == kStaging;
}

// Wait, s->mu held by lk, until pred(): polling the count of tickets issued
// first (the serving thread waits on the team, which issues a frame every
// few hundred microseconds), then blocking on `issued`.
template <class Pred>
void wait_issued(Stager* s, std::unique_lock<std::mutex>& lk, Pred pred) {
  while (!pred()) {
    const long long seen = s->n_issued.load(std::memory_order_relaxed);
    lk.unlock();
    const bool moved = spin([&] {
      return s->n_issued.load(std::memory_order_acquire) != seen;
    });
    lk.lock();
    if (!moved)
      s->issued.wait(lk, [&] {
        return s->n_issued.load(std::memory_order_relaxed) != seen;
      });
  }
}

// Whether ticket `id` is on its way: pending or being staged. A pending
// one the lead can no longer reach (no slot free, nothing in hand) is
// taken back here.
bool coming(Stager* s, long long id) {
  auto it = s->tickets.find(id);
  if (it == s->tickets.end()) return false;
  if (it->second.state == kPending && s->free_slots.empty()
      && s->busy == 0) {
    s->tickets.erase(it);
    return false;
  }
  return it->second.state != kIssued;
}

}  // namespace stage_ahead

// A stager over n_slots slots of slot_bytes at `pinned` (page-locked) and
// `dev` (on card `device`), its frames copied by a team of `threads`
// threads, and its lead. Null on failure, *err then the cudaError_t (-1:
// no thread could be started).
extern "C" void* stager_create(int device, int n_slots, long long slot_bytes,
                               void* pinned, void* dev, int threads,
                               int* err) {
  using namespace stage_ahead;
  Stager* s = new Stager;
  s->device = device;
  s->n_slots = n_slots;
  s->slot_bytes = slot_bytes;
  s->pinned = static_cast<char*>(pinned);
  s->dev = static_cast<char*>(dev);
  s->team_size = threads < 1 ? 1 : threads;
  for (Job& j : s->jobs) j.out.store(s->team_size);
  s->copied.assign(n_slots, nullptr);
  s->released.assign(n_slots, nullptr);
  s->has_copied.assign(n_slots, 0);
  s->has_released.assign(n_slots, 0);
  int before = 0;
  cudaGetDevice(&before);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking);
  for (int i = 0; i < n_slots && e == cudaSuccess; ++i) {
    e = cudaEventCreateWithFlags(&s->copied[i], cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&s->released[i], cudaEventDisableTiming);
    s->free_slots.push_back(i);
  }
  cudaSetDevice(before);
  *err = static_cast<int>(e);
  if (e == cudaSuccess) {
    try {
      for (int k = 0; k < s->team_size; ++k) s->team.emplace_back(team_main, s);
      s->lead = std::thread(lead_main, s);
      return s;
    } catch (...) {
      *err = -1;
    }
  }
  {
    std::lock_guard<std::mutex> lk(s->team_mu);
    s->team_stop.store(true, std::memory_order_release);
  }
  s->team_go.notify_all();
  for (auto& th : s->team) th.join();
  for (int i = 0; i < n_slots; ++i) {
    if (s->copied[i]) cudaEventDestroy(s->copied[i]);
    if (s->released[i]) cudaEventDestroy(s->released[i]);
  }
  if (s->stream) cudaStreamDestroy(s->stream);
  delete s;
  return nullptr;
}

// Stops and joins every thread of the stager once the frame in hand is
// issued, waits for its copies to the card, and frees it. Its slots'
// memory is the caller's.
extern "C" void stager_destroy(void* handle) {
  using namespace stage_ahead;
  Stager* s = static_cast<Stager*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop = true;
  }
  s->work.notify_all();
  s->lead.join();
  {
    std::lock_guard<std::mutex> lk(s->team_mu);
    s->team_stop.store(true, std::memory_order_release);
  }
  s->team_go.notify_all();
  for (auto& th : s->team) th.join();
  int before = 0;
  cudaGetDevice(&before);
  cudaSetDevice(s->device);
  cudaStreamSynchronize(s->stream);
  for (int i = 0; i < s->n_slots; ++i) {
    cudaEventDestroy(s->copied[i]);
    cudaEventDestroy(s->released[i]);
  }
  cudaStreamDestroy(s->stream);
  cudaSetDevice(before);
  delete s;
}

// A ticket for the frame of `rows` rows of `row_bytes` bytes, `pitch`
// bytes apart at `src` (rows * row_bytes <= the slots' bytes): its id,
// > 0. The caller keeps the frame's memory alive and unchanged until the
// ticket is released.
extern "C" long long stager_put(void* handle, const void* src,
                                long long rows, long long row_bytes,
                                long long pitch) {
  using namespace stage_ahead;
  Stager* s = static_cast<Stager*>(handle);
  long long id;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    id = s->next_id++;
    Ticket& t = s->tickets[id];
    t.frame.src = static_cast<const char*>(src);
    t.frame.rows = rows;
    t.frame.row_bytes = row_bytes;
    t.frame.pitch = pitch;
    s->queue.push_back(id);
  }
  s->work.notify_one();
  return id;
}

// Claims tickets ids[0..n): out[i] is kAhead (issued before this call),
// kWaited (issued during it: it was being staged, or pending with a slot
// free for it, which put it at the front of the queue) or kTaken (pending
// with no slot free, taken back, or unknown: the caller stages that
// frame). A claimed frame is copied from its
// device slot to dsts[i] (a device pointer) on `stream`, after its copy to
// the card; copies of neighbouring slots to neighbouring places go as
// one. A ticket may be claimed again (a retry) until it is released.
// Returns the first cudaError_t of those calls.
extern "C" int stager_claim(void* handle, int n, const long long* ids,
                            void* const* dsts, void* stream, int* out) {
  using namespace stage_ahead;
  Stager* s = static_cast<Stager*>(handle);
  std::vector<int> slot(n, -1);
  std::vector<long long> bytes(n, 0);
  {
    std::unique_lock<std::mutex> lk(s->mu);
    size_t free = s->free_slots.size();
    std::vector<long long> first;
    for (int i = 0; i < n; ++i) {
      auto it = s->tickets.find(ids[i]);
      if (it == s->tickets.end()) {
        out[i] = kTaken;
      } else if (it->second.state != kPending) {
        out[i] = it->second.state == kIssued ? kAhead : kWaited;
      } else if (free > 0) {
        --free;
        first.push_back(ids[i]);
        out[i] = kWaited;
      } else {
        s->tickets.erase(it);
        out[i] = kTaken;
      }
    }
    if (!first.empty()) {       // their old places in the queue go stale
      s->queue.insert(s->queue.begin(), first.begin(), first.end());
      s->work.notify_one();
    }
    wait_issued(s, lk, [&] {
      for (int i = 0; i < n; ++i)
        if (out[i] == kWaited && coming(s, ids[i])) return false;
      return true;
    });
    for (int i = 0; i < n; ++i) {
      if (out[i] == kTaken) continue;
      auto it = s->tickets.find(ids[i]);
      if (it == s->tickets.end()) {      // its staging failed
        out[i] = kTaken;
        continue;
      }
      slot[i] = it->second.slot;
      bytes[i] = it->second.frame.rows * it->second.frame.row_bytes;
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < n && err == cudaSuccess; ++i)
    if (slot[i] >= 0) err = cudaStreamWaitEvent(st, s->copied[slot[i]], 0);
  for (int i = 0; i < n && err == cudaSuccess;) {
    if (slot[i] < 0) {
      ++i;
      continue;
    }
    int j = i;
    long long run = bytes[i];
    while (j + 1 < n && slot[j + 1] == slot[j] + 1
           && bytes[j] == s->slot_bytes
           && static_cast<char*>(dsts[j + 1])
                  == static_cast<char*>(dsts[j]) + bytes[j]) {
      ++j;
      run += bytes[j];
    }
    err = cudaMemcpyAsync(dsts[i], s->dev + slot[i] * s->slot_bytes, run,
                          cudaMemcpyDeviceToDevice, st);
    i = j + 1;
  }
  return static_cast<int>(err);
}

// Releases tickets ids[0..n): a pending one is dropped, one being staged
// is waited for, and an issued one's slot is handed back once the work
// queued on `stream` so far has run. Unknown ids are skipped. Returns the
// first cudaError_t.
extern "C" int stager_release(void* handle, int n, const long long* ids,
                              void* stream) {
  using namespace stage_ahead;
  Stager* s = static_cast<Stager*>(handle);
  cudaError_t err = cudaSuccess;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    for (int i = 0; i < n; ++i) {
      wait_issued(s, lk, [&] { return !staging(s, ids[i]); });
      auto it = s->tickets.find(ids[i]);
      if (it == s->tickets.end()) continue;
      const int slot = it->second.slot;
      if (it->second.state == kIssued) {
        const cudaError_t e = cudaEventRecord(
            s->released[slot], static_cast<cudaStream_t>(stream));
        if (e == cudaSuccess) {
          s->has_released[slot] = 1;
        } else {                 // order by the host instead
          if (err == cudaSuccess) err = e;
          cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
          s->has_released[slot] = 0;
        }
        s->free_slots.push_back(slot);
      }
      s->tickets.erase(it);
    }
  }
  s->work.notify_one();
  return static_cast<int>(err);
}

// Tickets waiting for a slot, and slots held (being staged, issued or
// claimed), in *pending and *held; returns the threads' first CUDA error.
extern "C" int stager_counts(void* handle, int* pending, int* held) {
  using namespace stage_ahead;
  Stager* s = static_cast<Stager*>(handle);
  std::lock_guard<std::mutex> lk(s->mu);
  int p = 0;
  for (const auto& kv : s->tickets) p += kv.second.state == kPending;
  *pending = p;
  *held = s->n_slots - static_cast<int>(s->free_slots.size());
  return s->error;
}
// ---- stage ahead: end
#endif  // STENCIL_EXPR
