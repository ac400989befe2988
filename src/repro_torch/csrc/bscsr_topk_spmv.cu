// BS-CSR Top-K SpMV for Hopper (sm_90a): one query, or Q queries, per
// stream pass over the fused tile-packet words of every core, and the
// accumulate mode y = A x that keeps every row's sum.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bscsr_topk_spmv.py:
//   bscsr_topk_spmv_launch            -> bscsr_topk_spmv (_topk_spmv_kernel)
//   bscsr_topk_spmv_multiquery_launch -> bscsr_topk_spmv_multiquery
//                                        (_topk_spmv_mq_kernel)
//   bscsr_spmv_launch                 -> bscsr_spmv (_spmv_accum_kernel)
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): one pass must read every stream word once, ~4.1 bytes per stored
// nnz in BF16 with int16 column ids, so a single query is bound by bytes.  A
// batch adds 2 flops per nnz per query, so from about Q = 32 on the f32 rate
// bounds it instead.  The accumulate kernel is bound by bytes: on a 2**21-node
// graph operator (F32, int32 ids) y = A x moves 59.4 MB (the live packets, x
// and y), 0.018 ms.  wgmma has no role: the work is a gather and a scan.
//
// Design.  A step covers T packets of B nnz, one thread per nnz (T*B <= 1024):
//   stage 1  each thread decodes its nnz from the fused words (flag bit,
//            int16/int32 column id, f32/bf16/Q15/Q7 value; in a tagged
//            width class the core's header word picks BF16 or Q15, see
//            core_fmt) and multiplies by
//            x[col] (x in shared memory when it fits, else gathered from global
//            memory through L2; out-of-range ids read 0)
//   stage 2  block-wide inclusive scans of the flag bits (segment ids) and
//            of the products; a segment's sum is the difference of the prefix
//            at its last nnz and the prefix before its first nnz, as in the
//            reference's _segment_sums_linear
//   stage 3  the open row of the previous step is added to segment 0; the
//            last segment of the step stays open and is carried on
//   stage 4  (top-k) a completed row whose score is strictly above the scratchpad
//            minimum at the start of the step is appended to a candidate
//            list; one thread per query then inserts the list into its
//            k-entry scratchpad, ordered by (float total order desc, slot
//            asc), which is lax.top_k's order.  The result is independent of
//            the order of the list, so the append may race.
//   stage 4' (accumulate) a completed row's sum is stored at its slot.
// The one-query walks (single_walk, mq_walk at one query, accum_walk) share
// their arithmetic: the products' prefix sums go up one shuffle tree (a
// warp's 32 lanes, then the warps' totals, then each warp's offset added),
// so the single-query kernel and the multi-query kernel at Q = 1 give the
// same bits on the same stream.  The multi-query walk at Q >= 2 (rows_walk)
// sums each segment in stream order instead: the same bits on dyadic data,
// within f32 rounding of them otherwise.
//
// The accumulate kernel splits each core's stream among S blocks (grid
// C x S, S from the occupancy calculator: one wave fills the card).  A split
// table (spmv_split_table in the Python module) gives each split a step
// range [b, e): splits begin only at steps that hold at least one flag bit,
// and the last one ends at e_c, one past the core's last flagged step (later
// steps complete no row: only the open trailing row lies there, so a padded
// snapshot costs no more than a live one).  Exactness: the row open at a
// split's first step b completes inside step b, so its sequential sum is one
// f32 addition, head piece (segment 0 of step b, +0.0 when bit 0 is set)
// plus the carry that the single walk holds after step b-1.  Every carry
// inside split i-1 is already the sequential one, because the carry restarts
// at each completed row and split i-1's first step completes one.  So block
// i starts from carry 0.0 at row R(b) (the table's head_row), stores every
// row it completes but that one, and hands its head piece and final carry to
// (C, S) side buffers; the fix-up kernel stores 0.0f + (head + carry of split
// i-1) at R(b).  Each slot is still written once, with no float atomics, and
// the output equals the one-block walk (S = 1) bit for bit for every S.
// Within a step, accum_walk scans (flag, product) pairs in one pass with the
// same shuffle tree as the top-k walks (same f32 association, same bits) and
// double-buffers the carry, so a step costs 4 barriers, and it gathers x a
// step ahead.  The likely next limit is the bytes in flight (PERF.md): each
// thread holds one step of words in registers, so 3 blocks of 512 threads
// per SM (about 40 registers each) keep about 12 KB per SM in flight, which
// at HBM latency sustains well under 3.35 TB/s; the single-query kernel's
// ring of steps in shared memory (below) is the candidate fix.
//
// The multi-query kernel has two walks, chosen by the pass's Q, then the
// fold (topk_mq_merge_kernel).  Both walk the accumulate kernel's split
// table and cut every walk at e_c.  Each walker starts from carry 0.0 and
// empty scratchpads; a split after the first keeps the head piece of the
// row open at its first step (not a candidate there) and hands it, with
// every split's final carry, to (C, S, Q) side buffers, and its scratchpads
// to (C, S, Q, k) ones.  Exactness: a walk admits a row when it ranks
// before the k-th entry in lax.top_k order; slots rise along the walk, no
// candidate scores -0.0 (stage 3 adds +0.0 or a carry that is never -0.0)
// and NaN is never admitted, so that is "strictly above the k-th entry",
// and a walk's final scratchpad is the top k of the rows it completed.  The
// single walk's is then the top k of every split's top k and every split's
// head row (head score = head piece + carry of split i-1, the single walk's
// one f32 addition for that row), a set the fold kernel gathers over a
// warp's lanes in any order.  Every S gives the bits of S = 1.
//
// At Q = 1 (topk_spmv_mq1_kernel, mq_walk) a block of T*B threads walks a
// split one step at a time with the block scans above, the single-query
// kernel's bits.  At Q >= 2 (topk_spmv_rows_kernel, rows_walk) it replaced
// per-chunk block scans (8 queries a block, 3 barriers and 9 shuffle trees
// a step, every core's words read once per chunk) that reached 0.86% of the
// f32 bound at Q = 64.  Now a warp walks a split on its own, nnz by nnz in
// stream order, for every query of the block: each lane holds two queries
// (four above 32 queries a block at k <= 8), the block holds x transposed in
// shared memory (m + 1 rows of the block's queries and a pad, row m zeros
// for out-of-range ids), and every nnz is one broadcast read of its decoded
// (x row, value) pair, one 8- or 16-byte read of x and an f32 multiply and
// add a query, with no barrier, shuffle tree or candidate list.  A row's
// score in a step: its piece there, its products summed in stream order
// from +0.0 (__fmul_rn, __fadd_rn: no contraction), then one
// __fadd_rn(piece, carry) for the step's first segment (+0.0 for the
// others); the open row's carry is the step's piece plus the carry it came
// in with when the step holds no flag bit.  That is the per-step rule of
// the one-query walks with the piece summed in order instead of as a
// prefix difference, so a query's bits depend on neither the other queries
// of the pass, Q, S nor the walkers' layout.  Each walker keeps its
// scratchpads in registers (k rounded up to 4, 8 or 16; above 16 in its
// slice of the (C, S, Q, k) buffer) and inserts a row with a branch-free
// compare-and-shift.  Its packets come through a ring of D slots in shared
// memory: its lanes copy the 16-byte-aligned span around each packet with
// cp.async, 16 bytes a copy (one cp.async.bulk a 1 KB packet, as the
// single-query kernel stages its 2 KB steps, cost about 400 cycles of the
// copy unit each and bound the walk).  At small Q a warp holds several
// walkers (each on its own split, 32 / walkers lanes each), so the lanes a
// chunk of queries leaves idle walk other splits; below 8 warps a block it
// holds fewer, each on more lanes.  The walk reads the decoded pairs two at
// a time and issues a lane's 16 x reads before their adds.  At Q = 64,
// m = 512, k = 8 (10M x 512 BF16): 16 warps of two walkers of 16 lanes,
// S = 132, 4.4 ms on an H100; with 8 warps (no spill) 6.5 ms: the walk is
// held by latency, and x's reads alone would take 1.7 ms.
//
// The single-query kernel (topk_spmv_single_kernel, then the multi-query
// kernel's fold at one query) replaced a one-block walk per core that
// reached 1.8% of its byte bound: 32 of 132 SMs worked, a step cost 11
// barriers, and each thread loaded its step's words into registers one step
// ahead, about 2 KB a block in flight where 3.35 TB/s at about 1 us of
// memory latency needs about 25 KB per SM.  It walks the same split table
// on a grid of (core, split), S from the occupancy calculator (one wave),
// cuts every walk at e_c, and hands its scratchpad, head piece and carry to
// the fold's (C, S, 1, k) and (C, S, 1) buffers, so every S gives the bits
// of S = 1, and of the multi-query kernel at Q = 1.  Its steps arrive
// through a ring of D slots in shared memory: one thread stages step i + D
// with one bulk copy of the tensor memory accelerator (cp.async.bulk, an
// mbarrier per slot) once every thread has decoded step i, so D - 1 steps
// are in flight while the block scans (about 15 KB a block at BF16 and
// D = 8, three blocks an SM), and each thread decodes its nnz from shared
// memory.  A bulk copy needs a 16-byte address and size, which a step of a
// tagged stream (one word past its header) or of a small packet need not
// have, so each copy moves the 16-byte-aligned span around its step and the
// walk reads the step at its offset in the slot.  A step costs 2 barriers:
// every warp scans the warps' totals itself (the same tree, the same bits),
// the flag counts come from ballots and warp reductions, and stage 4 admits
// against a copy of the scratchpad minimum and inserts two steps later with
// one thread, as mq_walk does.  The decode is a template on the core's
// format, without branches.  With the bytes arriving ahead, what bounds it
// is the work per nnz (PERF.md): at the byte bound an SM must retire about
// 6 nnz a nanosecond, some 35 instructions a thread per nnz, where the
// shuffle trees, the barriers, the shared-memory loads and stage 3 take
// several times that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.40282347e+38f;  // np.finfo(np.float32).min

struct Params {
  const float* x;        // (Q, M) f32, queries of one pass
  const int32_t* words;  // (C, P, W) fused packet words
  float* out_v;          // (C, Q, k); accumulate mode: (C, n_rows) slot sums
  int32_t* out_r;        // (C, Q, k) per-core slot ids (top-k kernels only)
  int n_cores;
  long long n_packets;
  int width;             // W
  int m;                 // query width M
  int nq;                // Q
  int q_chunk;           // queries per block
  int block;             // B
  int per_step;          // T
  int col_words;         // B/2 (int16 ids) or B (int32 ids)
  int fmt;               // 0 F32, 1 BF16, 2 Q15, 3 Q7, 4 TAG2 (core_fmt)
  int k;
  int n_rows;            // slot budget: sentinel slot of empty entries
  int x_in_smem;
};

// The accumulate kernel's split table and side buffers.  A second kernel
// argument, not more Params fields: a wider Params changed the top-k
// kernels' code and cost them 11% at Q = 1 on an H100 (PERF.md).
struct Splits {
  const int32_t* bounds;    // (C, S+1) step bounds of each core's splits
  const int32_t* head_row;  // (C, S) slot of the row open at each split's start
  float* heads;             // (C, S) head piece of each split after the first
  float* carries;           // (C, S) open-row carry after each split's last step
  int n;                    // S
};

__host__ __device__ inline size_t align8(size_t n) { return (n + 7) & ~size_t(7); }

// Float total order as a signed int (-0.0 below +0.0), as lax.top_k ranks.
__device__ inline int total_key(float v) {
  int b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}

__device__ inline bool ranks_before(int ka, int ra, int kb, int rb) {
  return ka > kb || (ka == kb && ra < rb);
}

struct Raw {
  int flag_word, col_word, val_word;
};

// The format a core's value words decode as: p.fmt, except in the tagged
// 2-byte class (kTag2), where BF16 and Q15 share 2-byte words and the core's
// format code picks one.  A tagged stream reaches the kernels one word past
// its first header, with the row stride W of the tagged rows, so every
// section offset of an untagged row lands on the tagged row's section and
// a core's first header word sits one word before its first row.
// fuse_stream(tagged=True) writes the partition's code on every row,
// padding included, so one read per core serves the whole walk.  Q15's code
// (2) means Q15 and any other code BF16, as the reference's
// where(tag == Q15.code, q15, bf16).  TAG4 and TAG1 launch as F32 and Q7.
constexpr int kTag2 = 4;

__device__ inline int core_fmt(const Params& p, int core) {
  if (p.fmt != kTag2) return p.fmt;
  const int tag = __ldg(p.words + static_cast<long long>(core) * p.n_packets * p.width - 1);
  return tag == 2 ? 2 : 1;
}

__device__ inline void decode(const Params& p, int fmt, const Raw& r, int j, int* flag,
                              int* col, float* val) {
  *flag = (r.flag_word >> (j & 31)) & 1;
  if (p.col_words == p.block) {
    *col = r.col_word;
  } else {
    *col = static_cast<int16_t>((static_cast<unsigned>(r.col_word) >> ((j & 1) * 16)) & 0xffffu);
  }
  const unsigned w = static_cast<unsigned>(r.val_word);
  switch (fmt) {
    case 0: *val = __uint_as_float(w); break;
    case 1: *val = __uint_as_float(((w >> ((j & 1) * 16)) & 0xffffu) << 16); break;
    case 2: *val = __fmul_rn(static_cast<float>(static_cast<int16_t>((w >> ((j & 1) * 16)) & 0xffffu)),
                             3.0517578125e-05f); break;  // 2**-15
    default: *val = __fmul_rn(static_cast<float>(static_cast<int8_t>((w >> ((j & 3) * 8)) & 0xffu)),
                              0.0078125f); break;       // 2**-7
  }
}

// A thread's place in the accumulate walk, fixed for the whole walk: its
// packet row at the first step, the words per step, and the offsets of its
// flag, column and value words in a packet row.
struct Lane {
  const int32_t* row;
  long long stride;
  int j, off_f, off_c, off_v;
};

__device__ inline Lane lane_of(const Params& p, int core, long long first, int tid) {
  Lane l;
  l.j = tid % p.block;
  l.row = p.words + (static_cast<long long>(core) * p.n_packets + first * p.per_step +
                     tid / p.block) * p.width;
  l.stride = static_cast<long long>(p.per_step) * p.width;
  const int wf = p.block >> 5;
  l.off_f = l.j >> 5;
  l.off_c = wf + (p.col_words == p.block ? l.j : (l.j >> 1));
  l.off_v = wf + p.col_words + (p.fmt == 0 ? l.j : (p.fmt == 3 ? (l.j >> 2) : (l.j >> 1)));
  return l;
}

__device__ inline Raw load_lane(const Lane& l, const int32_t* row) {
  return Raw{__ldg(row + l.off_f), __ldg(row + l.off_c), __ldg(row + l.off_v)};
}

// The accumulate kernel's shared memory: x (when it fits), the step's flag
// bits, prefixes and segment starts, the pair scan's warp totals, and the
// open row's carry and slot, double-buffered by step parity.
struct AccumSmem {
  float* x;       // m (only when x_in_smem)
  int* flag;      // TB
  float* ps;      // TB
  float* start;   // TB + 1
  int* warp_i;    // 32
  float* warp_f;  // 32
  float* carry;   // 2
  int* row;       // 2
};

__host__ __device__ inline size_t accum_smem_bytes(int tb, int m, int x_in_smem) {
  size_t n = x_in_smem ? align8(sizeof(float) * size_t(m)) : 0;
  n += align8(sizeof(int) * tb) + align8(sizeof(float) * tb);
  n += align8(sizeof(float) * (tb + 1)) + 2 * align8(sizeof(int) * 32);
  return n + 2 * align8(sizeof(float) * 2);
}

__device__ inline AccumSmem accum_carve(unsigned char* base, int tb, int m, int x_in_smem) {
  AccumSmem s;
  unsigned char* p = base;
  auto take = [&p](size_t bytes) { unsigned char* r = p; p += align8(bytes); return r; };
  s.x = x_in_smem ? reinterpret_cast<float*>(take(sizeof(float) * size_t(m))) : nullptr;
  s.flag = reinterpret_cast<int*>(take(sizeof(int) * tb));
  s.ps = reinterpret_cast<float*>(take(sizeof(float) * tb));
  s.start = reinterpret_cast<float*>(take(sizeof(float) * (tb + 1)));
  s.warp_i = reinterpret_cast<int*>(take(sizeof(int) * 32));
  s.warp_f = reinterpret_cast<float*>(take(sizeof(float) * 32));
  s.carry = reinterpret_cast<float*>(take(sizeof(float) * 2));
  s.row = reinterpret_cast<int*>(take(sizeof(int) * 2));
  return s;
}

// Stages 1-3 and 4' of the accumulate kernel: block (core, split) walks
// steps [first, stop) of its core from carry row `row_start` and carry 0.0
// and stores each completed row's sum, 0.0f + c (the bits the reference's
// scatter-add onto zeros gives), at its slot of the zero-filled (C, n_rows)
// output; slot ids never repeat, so plain stores suffice.  In head mode (a
// split after the first, which starts at a flagged step) the row open at
// `first` completes in that step, but only the fix-up knows its carry: its
// head piece goes to `heads`, and every split's final carry to `carries`.
//
// The flag scan and the product scan are one pair scan: the top-k kernels'
// shuffle tree for both (so the same f32 association and the same bits),
// with 3 barriers; the prefixes are published by the scan's last barrier;
// the carry and carry row are double-buffered, so a step costs 4 barriers.
// The words are
// loaded two steps ahead and x gathered one step ahead (the gather depends
// on the decoded column id), so neither load waits on the step's scans.
__device__ void accum_walk(const Params& p, const Splits& sp, int core, int split,
                           long long first, long long stop, int row_start, bool head) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = tb >> 5;
  AccumSmem s = accum_carve(smem_raw, tb, p.m, p.x_in_smem);
  if (p.x_in_smem) {
    for (int i = tid; i < p.m; i += tb) s.x[i] = p.x[i];
  }
  if (tid == 0) {
    s.carry[0] = 0.0f;
    s.row[0] = row_start;
  }
  __syncthreads();

  const Lane lane_pos = lane_of(p, core, first, tid);
  const int32_t* row = lane_pos.row;
  const int fmt = core_fmt(p, core);
  auto gather = [&](int c) {
    return (c >= 0 && c < p.m) ? (p.x_in_smem ? s.x[c] : __ldg(p.x + c)) : 0.0f;
  };
  int f, col;
  float v;
  decode(p, fmt, load_lane(lane_pos, row), lane_pos.j, &f, &col, &v);
  float xv = gather(col);
  Raw next{0, 0, 0};
  if (first + 1 < stop) {
    row += lane_pos.stride;
    next = load_lane(lane_pos, row);
  }
  for (long long step = first; step < stop; ++step) {
    const int buf = static_cast<int>((step - first) & 1);
    const float prod = __fmul_rn(v, xv);
    // The next step's nnz is decoded and its x gather started now; its words were
    // loaded a step ago.
    int f_next = 0;
    if (step + 1 < stop) {
      decode(p, fmt, next, lane_pos.j, &f_next, &col, &v);
      xv = gather(col);
      if (step + 2 < stop) {
        row += lane_pos.stride;
        next = load_lane(lane_pos, row);
      }
    }
    s.flag[tid] = f;
    // ---- stage 2: pair scan of (flag, product) ----
    int seg = f;
    float ps = prod;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int yi = __shfl_up_sync(0xffffffffu, seg, d);
      const float yf = __shfl_up_sync(0xffffffffu, ps, d);
      if (lane >= d) {
        seg += yi;
        ps = __fadd_rn(ps, yf);
      }
    }
    if (lane == 31) {
      s.warp_i[warp] = seg;
      s.warp_f[warp] = ps;
    }
    __syncthreads();
    if (warp == 0) {
      int wi = lane < nwarps ? s.warp_i[lane] : 0;
      float wf = lane < nwarps ? s.warp_f[lane] : 0.0f;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int yi = __shfl_up_sync(0xffffffffu, wi, d);
        const float yf = __shfl_up_sync(0xffffffffu, wf, d);
        if (lane >= d) {
          wi += yi;
          wf = __fadd_rn(wf, yf);
        }
      }
      if (lane < nwarps) {
        s.warp_i[lane] = wi;
        s.warp_f[lane] = wf;
      }
    }
    __syncthreads();
    if (warp > 0) {
      seg += s.warp_i[warp - 1];
      ps = __fadd_rn(ps, s.warp_f[warp - 1]);
    }
    const int s_last = s.warp_i[nwarps - 1];
    s.ps[tid] = ps;
    __syncthreads();  // publishes the prefixes; the warp totals are free again
    const int row0 = s.row[buf];
    const float part = s.carry[buf];
    const bool is_last = tid == tb - 1 || s.flag[tid + 1] != 0;
    if (f) s.start[seg] = tid > 0 ? s.ps[tid - 1] : 0.0f;
    __syncthreads();  // publishes the segment starts
    // ---- stage 3 and 4' ----
    const bool at_head = head && step == first;
    float* out = p.out_v + static_cast<long long>(core) * p.n_rows;
    if (tid == 0 && f) {
      // Segment 0 is empty: the carried row completes with its partial sum.
      if (at_head) {
        sp.heads[core * sp.n + split] = 0.0f;
      } else if (row0 >= 0 && row0 < p.n_rows) {
        out[row0] = __fadd_rn(0.0f, __fadd_rn(0.0f, part));
      }
    }
    if (is_last) {
      const float base = seg == 0 ? 0.0f : s.start[seg];
      const float c = __fadd_rn(__fsub_rn(ps, base), seg == 0 ? part : 0.0f);
      const int r = row0 + seg;
      if (seg == s_last) {
        s.carry[buf ^ 1] = c;  // thread tb - 1: the open row goes on
      } else if (at_head && seg == 0) {
        sp.heads[core * sp.n + split] = __fsub_rn(ps, base);
      } else if (r >= 0 && r < p.n_rows) {
        out[r] = __fadd_rn(0.0f, c);
      }
    }
    if (tid == 0) s.row[buf ^ 1] = row0 + s_last;
    f = f_next;
  }
  if (tid == tb - 1) sp.carries[core * sp.n + split] = s.carry[(stop - first) & 1];
}

// Block (core, split) walks one split; an empty split (trailing) returns.
__global__ void spmv_accum_kernel(Params p, Splits sp) {
  const int core = blockIdx.x, split = blockIdx.y;
  const int32_t* b = sp.bounds + core * (sp.n + 1) + split;
  const long long first = b[0], stop = b[1];
  if (first >= stop) return;
  accum_walk(p, sp, core, split, first, stop, sp.head_row[core * sp.n + split], split > 0);
}

// The fix-up: the row open at the start of each non-empty split i > 0
// completes as head piece + the carry of split i - 1 (non-empty splits are
// a prefix), the one f32 addition the single walk makes there.  Only this
// kernel stores that slot, so every slot is still written at most once.
__global__ void spmv_fixup_kernel(Params p, Splits sp) {
  const int core = blockIdx.x;
  const int32_t* b = sp.bounds + core * (sp.n + 1);
  for (int i = threadIdx.x + 1; i < sp.n; i += blockDim.x) {
    const int r = sp.head_row[core * sp.n + i];
    if (b[i] >= b[i + 1] || r < 0 || r >= p.n_rows) continue;
    const float c = __fadd_rn(sp.heads[core * sp.n + i], sp.carries[core * sp.n + i - 1]);
    p.out_v[static_cast<long long>(core) * p.n_rows + r] = __fadd_rn(0.0f, c);
  }
}

// The multi-query kernel's split table and side buffers.  A second kernel
// argument, as Splits is for the accumulate kernel.
struct MqSplits {
  const int32_t* bounds;    // (C, S+1) step bounds of each core's splits
  const int32_t* head_row;  // (C, S) slot of the row open at each split's start
  float* pad_v;             // (C, S, Q, k) each split's scratchpad (S = 1: the output)
  int32_t* pad_r;           // (C, S, Q, k)
  float* heads;             // (C, S, Q) head piece of each split after the first
  float* carries;           // (C, S, Q) open-row carry after each split's last step
  int n;                    // S
};

// The one-query multi-query walk's shared memory (qc = 1): x (when it
// fits), every query's prefixes, the warps' flag bits (by step parity), the
// scans' warp totals (column 0 the flags, column 1 + q query q's products),
// the scratchpads, the carries (by step parity) and admission thresholds,
// the carry row and the candidate lists (both by step parity).
struct MqSmem {
  float* x;       // qc * m (only when x_in_smem)
  float* ps;      // qc * TB
  unsigned* fw;   // 2 * 32
  int* warp_i;    // 32
  float* warp_f;  // qc * 32
  float* acc_v;   // qc * k, sorted by (total order desc, slot asc)
  int* acc_r;     // qc * k
  float* carry;   // 2 * qc, then qc thresholds (mq_walk's `thr`)
  int* row;       // 2
  float* cand_v;  // 2 * qc * (TB + 1)
  int* cand_r;    // 2 * qc * (TB + 1)
  int* cand_n;    // 2 * qc
};

__host__ __device__ inline size_t mq_smem_bytes(int tb, int qc, int k, int m, int x_in_smem) {
  const size_t q = size_t(qc);
  size_t n = x_in_smem ? align8(sizeof(float) * q * m) : 0;
  n += align8(sizeof(float) * q * tb) + align8(sizeof(unsigned) * 64);
  n += align8(sizeof(int) * 32) + align8(sizeof(float) * q * 32);
  n += 2 * align8(sizeof(float) * q * k);
  n += align8(sizeof(float) * 3 * q) + align8(sizeof(int) * 2);
  n += 2 * align8(sizeof(float) * 2 * q * (tb + 1));
  return n + align8(sizeof(int) * 2 * q);
}

__device__ inline MqSmem mq_carve(unsigned char* base, int tb, int qc, int k, int m,
                                  int x_in_smem) {
  MqSmem s;
  unsigned char* p = base;
  auto take = [&p](size_t bytes) { unsigned char* r = p; p += align8(bytes); return r; };
  const size_t q = size_t(qc);
  s.x = x_in_smem ? reinterpret_cast<float*>(take(sizeof(float) * q * m)) : nullptr;
  s.ps = reinterpret_cast<float*>(take(sizeof(float) * q * tb));
  s.fw = reinterpret_cast<unsigned*>(take(sizeof(unsigned) * 64));
  s.warp_i = reinterpret_cast<int*>(take(sizeof(int) * 32));
  s.warp_f = reinterpret_cast<float*>(take(sizeof(float) * q * 32));
  s.acc_v = reinterpret_cast<float*>(take(sizeof(float) * q * k));
  s.acc_r = reinterpret_cast<int*>(take(sizeof(int) * q * k));
  s.carry = reinterpret_cast<float*>(take(sizeof(float) * 3 * q));
  s.row = reinterpret_cast<int*>(take(sizeof(int) * 2));
  s.cand_v = reinterpret_cast<float*>(take(sizeof(float) * 2 * q * (tb + 1)));
  s.cand_r = reinterpret_cast<int*>(take(sizeof(int) * 2 * q * (tb + 1)));
  s.cand_n = reinterpret_cast<int*>(take(sizeof(int) * 2 * q));
  return s;
}

// (c, r) into a sorted k-entry list when it ranks before the last entry.
__device__ inline void insert_sorted(float* av, int* ar, int k, float c, int r) {
  const int kc = total_key(c);
  if (!ranks_before(kc, r, total_key(av[k - 1]), ar[k - 1])) return;
  int pos = k - 1;
  while (pos > 0 && ranks_before(kc, r, total_key(av[pos - 1]), ar[pos - 1])) {
    av[pos] = av[pos - 1];
    ar[pos] = ar[pos - 1];
    --pos;
  }
  av[pos] = c;
  ar[pos] = r;
}

// Stages 1-4 of the multi-query kernel at one query: block (core, split,
// query) walks n_steps steps of its core from `first` for queries q0 .. q0+nq-1, from
// carry row `row_start`, carry 0.0 and empty scratchpads, and stores each
// query's scratchpad in its slice of pad_v / pad_r.  In head mode (a split
// after the first, which starts at a flagged step) the row open at `first`
// completes in that step, but only the fold knows its carry: its head piece
// goes to `heads`, and every split's final carry to `carries`.
//
// Stage 2 is one scan pass: every query's product goes up the warp shuffle
// tree in the same loop (each lane adds the lane d below it, d = 1, 2, 4,
// 8, 16), the warp totals are scanned by one warp per column (the flag
// counts, then each query) with the same tree, and each thread adds its
// warp's offset: the association of the single-query and accumulate
// walks, so the same bits.  The flags are counted from a warp ballot.  A segment's
// start prefix is read at the nnz before its first, found in the ballots, so
// no array of starts is published.  A step's candidates are inserted two
// steps later (lists double-buffered by step parity), by one thread per
// query while the other warps decode, so no barrier waits for them:
// admission then compares with a minimum that may not hold the previous
// step's candidates yet, a lower threshold that admits more candidates, and
// insertion ranks each one exactly against the current k-th entry, so the
// scratchpad ends the same.  Admission reads a copy of the minimum that the
// inserting thread stores once its insertions are done (`thr`), never the
// list that thread is writing.  Three barriers a step (warp totals,
// scanned totals, prefixes).
__device__ void mq_walk(const Params& p, const MqSplits& sp, int core, int split, int q0,
                        int nq, long long first, int n_steps, int row_start, bool head) {
  constexpr int QC = 1;  // queries a block: Q >= 2 takes rows_walk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = tb >> 5;
  const int k = p.k;
  const int cap = tb + 1;  // candidates a query can have in one step
  MqSmem s = mq_carve(smem_raw, tb, QC, k, p.m, p.x_in_smem);
  // Each query's admission threshold, acc_v's last entry once an insertion
  // is done.  Addressed from `carry`: one pointer fewer to keep live in the
  // one-query kernel, which is held to 40 registers.
  volatile float* thr = s.carry + 2 * QC;
  if (p.x_in_smem) {
    const float* xs = p.x + static_cast<long long>(q0) * p.m;
    for (int i = tid; i < nq * p.m; i += tb) s.x[i] = xs[i];
  }
  for (int i = tid; i < QC * k; i += tb) {
    s.acc_v[i] = kNegInf;
    s.acc_r[i] = p.n_rows;
  }
  if (tid < 2 * QC) s.cand_n[tid] = 0;
  if (tid < QC) {
    thr[tid] = kNegInf;
    s.carry[tid] = 0.0f;
  }
  if (tid == 0) s.row[0] = row_start;
  __syncthreads();

  const Lane lp = lane_of(p, core, first, tid);
  const int32_t* row = lp.row;
  const int fmt = core_fmt(p, core);
  auto gather = [&](int c, int q) {
    if (q >= nq || c < 0 || c >= p.m) return 0.0f;
    return p.x_in_smem ? s.x[q * p.m + c]
                       : __ldg(p.x + static_cast<long long>(q0 + q) * p.m + c);
  };
  // Query `q`'s candidates of the step of parity `b` into its sorted
  // scratchpad.  The result is independent of the list's order, so the
  // appends may race.  Other warps may still admit the previous step's rows
  // while this runs, so they read `thr`, never acc_v: one volatile store
  // after the insertions, so a reader sees the minimum of a finished state
  // (at most the step-start minimum) and never a store the compiler makes
  // into acc_v while it shifts.
  auto insert = [&](int q, int b) {
    int* n = s.cand_n + b * QC + q;
    const float* cv = s.cand_v + (b * QC + q) * cap;
    const int* cr = s.cand_r + (b * QC + q) * cap;
    float* av = s.acc_v + q * k;
    for (int i = 0; i < *n; ++i) insert_sorted(av, s.acc_r + q * k, k, cv[i], cr[i]);
    *n = 0;
    thr[q] = av[k - 1];
  };
  auto head_out = [&](int q, float piece) {
    sp.heads[(static_cast<long long>(core) * sp.n + split) * p.nq + q0 + q] = piece;
  };
  int f, col;
  float v;
  decode(p, fmt, load_lane(lp, row), lp.j, &f, &col, &v);
  float xv[QC];
#pragma unroll
  for (int q = 0; q < QC; ++q) xv[q] = gather(col, q);
  Raw next{0, 0, 0};
  if (n_steps > 1) {
    row += lp.stride;
    next = load_lane(lp, row);
  }
  for (int i = 0; i < n_steps; ++i) {
    const int buf = i & 1;
    // The candidates of step i - 2 (the list of this parity), whose appends
    // ended before step i - 1's first barrier, while the other warps decode.
    if (tid < nq) insert(tid, buf);
    float ps[QC];
#pragma unroll
    for (int q = 0; q < QC; ++q) ps[q] = __fmul_rn(v, xv[q]);
    // The next step's nnz is decoded and its x gathered now; its words were
    // loaded a step ago.
    int f_next = 0;
    if (i + 1 < n_steps) {
      decode(p, fmt, next, lp.j, &f_next, &col, &v);
#pragma unroll
      for (int q = 0; q < QC; ++q) xv[q] = gather(col, q);
      if (i + 2 < n_steps) {
        row += lp.stride;
        next = load_lane(lp, row);
      }
    }
    // ---- stage 2: one scan of the flag bits and every query's products ----
    // The flag scan is an integer count, so a ballot and a popcount give it
    // without a shuffle tree; the products keep the shuffle tree.
    const unsigned bits = __ballot_sync(0xffffffffu, f);
    unsigned* fw = s.fw + buf * 32;
    int seg = __popc(bits & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const float y = __shfl_up_sync(0xffffffffu, ps[q], d);
        if (lane >= d) ps[q] = __fadd_rn(ps[q], y);
      }
    }
    if (lane == 31) {
      fw[warp] = bits;
      s.warp_i[warp] = seg;
#pragma unroll
      for (int q = 0; q < QC; ++q) s.warp_f[q * 32 + warp] = ps[q];
    }
    __syncthreads();
    for (int c = warp; c <= QC; c += nwarps) {
      if (c == 0) {
        int w = lane < nwarps ? s.warp_i[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, w, d);
          if (lane >= d) w += y;
        }
        if (lane < nwarps) s.warp_i[lane] = w;
      } else {
        float* tot = s.warp_f + (c - 1) * 32;
        float w = lane < nwarps ? tot[lane] : 0.0f;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, w, d);
          if (lane >= d) w = __fadd_rn(w, y);
        }
        if (lane < nwarps) tot[lane] = w;
      }
    }
    // The nnz after this one opens a segment (the last nnz of the step
    // always closes one).
    const bool is_last =
        lane < 31 ? ((bits >> (lane + 1)) & 1u) != 0 : (warp + 1 == nwarps || (fw[warp + 1] & 1u));
    __syncthreads();
    if (warp > 0) {
      seg += s.warp_i[warp - 1];
#pragma unroll
      for (int q = 0; q < QC; ++q) ps[q] = __fadd_rn(ps[q], s.warp_f[q * 32 + warp - 1]);
    }
    const int s_last = s.warp_i[nwarps - 1];
#pragma unroll
    for (int q = 0; q < QC; ++q) s.ps[q * tb + tid] = ps[q];
    __syncthreads();  // publishes the prefixes
    const int row0 = s.row[buf];
    // ---- stages 3 and 4, every query between the same barriers ----
    const bool at_head = head && i == 0;
    auto row_done = [&](int q, int r, float c) {
      // A candidate: strictly above the scratchpad minimum, which may not
      // hold the previous step's candidates yet (a lower threshold).
      if (c > thr[q]) {
        const int at = atomicAdd(s.cand_n + buf * QC + q, 1);
        s.cand_v[(buf * QC + q) * cap + at] = c;
        s.cand_r[(buf * QC + q) * cap + at] = r;
      }
    };
    if (tid == 0 && f) {
      // Segment 0 is empty: the carried row completes with its partial sum.
      for (int q = 0; q < nq; ++q) {
        if (at_head) {
          head_out(q, 0.0f);
        } else if (row0 >= 0) {
          row_done(q, row0, __fadd_rn(0.0f, s.carry[buf * QC + q]));
        }
      }
    }
    if (is_last) {
      // The segment's first nnz: the last flag bit at or before this one
      // (none for segment 0, whose prefix starts at 0.0).
      int start = 0;
      if (seg > 0) {
        unsigned m = bits & (0xffffffffu >> (31 - lane));
        int w = warp;
        while (m == 0) m = fw[--w];
        start = w * 32 + 31 - __clz(static_cast<int>(m));
      }
      const int r = row0 + seg;
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const float base = start > 0 ? s.ps[q * tb + start - 1] : 0.0f;
        const float piece = __fsub_rn(ps[q], base);
        const float c = __fadd_rn(piece, seg == 0 ? s.carry[buf * QC + q] : 0.0f);
        if (seg == s_last) {
          s.carry[(buf ^ 1) * QC + q] = c;  // thread tb - 1: the open row goes on
        } else if (q < nq) {
          if (at_head && seg == 0) {
            head_out(q, piece);
          } else if (r >= 0) {
            row_done(q, r, c);
          }
        }
      }
    }
    if (tid == 0) s.row[buf ^ 1] = row0 + s_last;
    f = f_next;
  }
  __syncthreads();
  if (tid < nq) {
    insert(tid, 0);  // the last two steps' candidates
    insert(tid, 1);
  }
  __syncthreads();
  const long long out = ((static_cast<long long>(core) * sp.n + split) * p.nq + q0) * k;
  for (int i = tid; i < nq * k; i += tb) {
    sp.pad_v[out + i] = s.acc_v[i];
    sp.pad_r[out + i] = s.acc_r[i];
  }
  if (tid == tb - 1) {
    float* carries = sp.carries + (static_cast<long long>(core) * sp.n + split) * p.nq + q0;
    for (int q = 0; q < nq; ++q) carries[q] = s.carry[(n_steps & 1) * QC + q];
  }
}

// Block (core, split, query chunk) walks one split for its chunk; an empty
// split (trailing) holds no row, so its scratchpads stay empty.
__device__ void mq_split(const Params& p, const MqSplits& sp) {
  const int core = blockIdx.x, split = blockIdx.y;
  const int q0 = blockIdx.z * p.q_chunk;
  const int nq = min(p.q_chunk, p.nq - q0);
  const int32_t* b = sp.bounds + core * (sp.n + 1) + split;
  if (b[0] >= b[1]) {
    const long long out = ((static_cast<long long>(core) * sp.n + split) * p.nq + q0) * p.k;
    for (int i = threadIdx.x; i < nq * p.k; i += blockDim.x) {
      sp.pad_v[out + i] = kNegInf;
      sp.pad_r[out + i] = p.n_rows;
    }
    return;
  }
  mq_walk(p, sp, core, split, q0, nq, b[0], b[1] - b[0],
              sp.head_row[core * sp.n + split], split > 0);
}

// Registers: a block of one query is held to 40, so 3 blocks of 512 threads
// share an SM (S = 12 at c = 32 instead of 8).
__global__ void __maxnreg__(40) topk_spmv_mq1_kernel(Params p, MqSplits sp) {
  mq_split(p, sp);
}

// Sorted list b (k entries, any memory) into sorted list a (k entries) in
// place: the top k of both in lax.top_k order, merged from the back once it
// is known how many entries each list gives.
__device__ inline void merge_sorted(float* av, int* ar, const float* bv, const int32_t* br,
                                    int k) {
  int na = 0, nb = 0;
  while (na + nb < k) {
    if (ranks_before(total_key(bv[nb]), br[nb], total_key(av[na]), ar[na])) {
      ++nb;
    } else {
      ++na;
    }
  }
  for (int o = k - 1, x = na - 1, y = nb - 1; o >= 0; --o) {
    if (x >= 0 && (y < 0 || ranks_before(total_key(bv[y]), br[y], total_key(av[x]), ar[x]))) {
      av[o] = av[x];
      ar[o] = ar[x];
      --x;
    } else {
      av[o] = bv[y];
      ar[o] = br[y];
      --y;
    }
  }
}

// The fold: one block of L <= 32 lanes per (core, query) joins the splits'
// scratchpads.  The single walk's scratchpad is the top k, in lax.top_k
// order, of every split's scratchpad and the head row of each non-empty
// split i > 0, scored head piece + the carry of split i - 1 (the single
// walk's stage-3 addition for that row): a row ranks before the k-th entry
// of the rows before it exactly when it is above it (its slot is higher),
// and a head row's score is never -0.0 or NaN-admitted.  That set does not
// depend on the order it is gathered in, so lane l folds splits l, l + L,
// ... into a list of its own (in shared memory), and the lanes' lists are
// then merged pairwise in log2(L) rounds.
__global__ void topk_mq_merge_kernel(Params p, MqSplits sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = p.k, n_splits = sp.n, lane = threadIdx.x, lanes = blockDim.x;
  const int core = blockIdx.x / p.nq, q = blockIdx.x % p.nq;
  float* lv = reinterpret_cast<float*>(smem_raw);
  int* lr = reinterpret_cast<int*>(lv + lanes * k);
  float* av = lv + lane * k;
  int* ar = lr + lane * k;
  auto at = [&](int i) { return (static_cast<long long>(core) * n_splits + i) * p.nq + q; };
  for (int j = 0; j < k; ++j) {
    av[j] = kNegInf;
    ar[j] = p.n_rows;
  }
  // Non-empty splits are a prefix.
  const int32_t* b = sp.bounds + core * (n_splits + 1);
  for (int i = lane; i < n_splits && b[i] < b[i + 1]; i += lanes) {
    if (i > 0) {
      const int r = sp.head_row[core * n_splits + i];
      const float c = __fadd_rn(sp.heads[at(i)], sp.carries[at(i - 1)]);
      if (r >= 0 && c > av[k - 1]) insert_sorted(av, ar, k, c, r);
    }
    merge_sorted(av, ar, sp.pad_v + at(i) * k, sp.pad_r + at(i) * k, k);
  }
  __syncwarp();
  for (int d = 1; d < lanes; d <<= 1) {
    if ((lane & (2 * d - 1)) == 0 && lane + d < lanes) {
      merge_sorted(av, ar, lv + (lane + d) * k, lr + (lane + d) * k, k);
    }
    __syncwarp();
  }
  const long long o = (static_cast<long long>(core) * p.nq + q) * k;
  for (int j = lane; j < k; j += lanes) {
    p.out_v[o + j] = lv[j];
    p.out_r[o + j] = lr[j];
  }
}

// The single-query kernel's ring of steps: a third kernel argument, so the
// shared Params keeps its width (a wider Params cost the top-k kernels 11%
// at Q = 1 on an H100, PERF.md).
struct Ring {
  int depth;       // D slots (at least 2)
  int step_words;  // words a step's walk reads, from its first (T*W, less
                   // the next row's header word in a tagged stream)
  int slot_words;  // a slot: the 16-byte-aligned span around a step
};

// The single-query walk's shared memory: the ring (first, so each slot is
// 16-byte aligned) and its mbarriers, x (when it fits), the prefixes, the
// warps' flag bits (by step parity) and product totals, the scratchpad, the
// carry (by step parity) and admission threshold, and the candidate lists
// (by step parity).
struct SingleSmem {
  int32_t* ring;             // depth * slot_words
  unsigned long long* full;  // depth: slot d holds its step once complete
  float* x;                  // m (only when x_in_smem)
  float* ps;                 // TB
  unsigned* fw;              // 2 * 32
  float* warp_f;             // 32
  float* acc_v;              // k, sorted by (total order desc, slot asc)
  int* acc_r;                // k
  float* carry;              // 2, then the threshold (single_walk's `thr`)
  float* cand_v;             // 2 * (TB + 1)
  int* cand_r;               // 2 * (TB + 1)
  int* cand_n;               // 2
};

__host__ __device__ inline size_t single_smem_bytes(int tb, int k, int m, int x_in_smem,
                                                    const Ring& ring) {
  size_t n = sizeof(int32_t) * size_t(ring.depth) * ring.slot_words;
  n += align8(sizeof(unsigned long long) * ring.depth);
  n += x_in_smem ? align8(sizeof(float) * size_t(m)) : 0;
  n += align8(sizeof(float) * tb) + align8(sizeof(unsigned) * 64) + align8(sizeof(float) * 32);
  n += 2 * align8(sizeof(float) * k) + align8(sizeof(float) * 3);
  n += 2 * align8(sizeof(float) * 2 * (tb + 1));
  return n + align8(sizeof(int) * 2);
}

__device__ inline SingleSmem single_carve(unsigned char* base, int tb, int k, int m,
                                          int x_in_smem, const Ring& ring) {
  SingleSmem s;
  unsigned char* p = base;
  auto take = [&p](size_t bytes) { unsigned char* r = p; p += align8(bytes); return r; };
  s.ring = reinterpret_cast<int32_t*>(take(sizeof(int32_t) * size_t(ring.depth) * ring.slot_words));
  s.full = reinterpret_cast<unsigned long long*>(take(sizeof(unsigned long long) * ring.depth));
  s.x = x_in_smem ? reinterpret_cast<float*>(take(sizeof(float) * size_t(m))) : nullptr;
  s.ps = reinterpret_cast<float*>(take(sizeof(float) * tb));
  s.fw = reinterpret_cast<unsigned*>(take(sizeof(unsigned) * 64));
  s.warp_f = reinterpret_cast<float*>(take(sizeof(float) * 32));
  s.acc_v = reinterpret_cast<float*>(take(sizeof(float) * k));
  s.acc_r = reinterpret_cast<int*>(take(sizeof(int) * k));
  s.carry = reinterpret_cast<float*>(take(sizeof(float) * 3));
  s.cand_v = reinterpret_cast<float*>(take(sizeof(float) * 2 * (tb + 1)));
  s.cand_r = reinterpret_cast<int*>(take(sizeof(int) * 2 * (tb + 1)));
  s.cand_n = reinterpret_cast<int*>(take(sizeof(int) * 2));
  return s;
}

__device__ inline uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Step `step` of `core` into a ring slot: one bulk copy of the 16-byte-
// aligned span around the step, whose arrival completes the slot's
// mbarrier.  The span reads at most 12 bytes on either side of the step,
// inside 16-byte blocks that hold stream words, so never an unmapped page.
__device__ inline void stage_step(const Params& p, const Ring& ring, int32_t* slot,
                                  unsigned long long* full, int core, long long step) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(
      p.words + (static_cast<long long>(core) * p.n_packets + step * p.per_step) * p.width);
  const uintptr_t lo = at & ~uintptr_t(15);
  const uint32_t bytes =
      static_cast<uint32_t>(((at + 4u * ring.step_words + 15u) & ~uintptr_t(15)) - lo);
  const uint32_t bar = shared_addr(full);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(shared_addr(slot)), "l"(static_cast<unsigned long long>(lo)), "r"(bytes), "r"(bar)
      : "memory");
}

// Until the slot's fill of parity `parity` has arrived.
__device__ inline void wait_full(unsigned long long* full, uint32_t parity) {
  const uint32_t bar = shared_addr(full);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred ready;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, ready;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Stages 1-4 of the single-query kernel: block (core, split) walks n_steps
// steps of its core from `first`, from carry row `row_start`, carry 0.0
// and an empty scratchpad, and stores the scratchpad in its slice of
// pad_v / pad_r; in head mode (a split after the first) the head piece of
// the row open at `first` goes to `heads` and every split's final carry to
// `carries`, as in mq_walk, and the fold joins them.
//
// The steps come through the ring: thread 0 stages step i + D into the slot
// of step i after the step's first barrier (every thread decoded step i a
// step earlier), and each thread waits on the slot's mbarrier before it
// decodes the next step from it.  Stage 2 keeps mq_walk's association: the
// products go up the warp shuffle tree, every warp scans the 16 or so warp
// totals with the same tree (no barrier for one warp to publish them), and
// each thread adds its warp's offset.  The flag counts are exact integers,
// so a ballot, a popcount and two warp reductions give a thread's segment
// and the step's last one.  Stage 4 is mq_walk's at one query: admission
// against `thr`, a copy of the scratchpad minimum that may lag, and
// insertion by thread 0 two steps later.  Two barriers a step: warp totals
// published, prefixes published.  The carry row is a register of every
// thread (each knows the step's segment count).
template <int FMT>
__device__ void single_walk(const Params& p, const MqSplits& sp, const Ring& ring, int core,
                            int split, long long first, int n_steps, int row_start,
                            bool head) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = tb >> 5;
  const int k = p.k;
  const int cap = tb + 1;  // candidates one step can bring
  SingleSmem s = single_carve(smem_raw, tb, k, p.m, p.x_in_smem, ring);
  volatile float* thr = s.carry + 2;
  if (tid == 0) {
    for (int d = 0; d < ring.depth; ++d) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(shared_addr(s.full + d)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.x_in_smem) {
    for (int i = tid; i < p.m; i += tb) s.x[i] = p.x[i];
  }
  for (int i = tid; i < k; i += tb) {
    s.acc_v[i] = kNegInf;
    s.acc_r[i] = p.n_rows;
  }
  if (tid < 2) s.cand_n[tid] = 0;
  if (tid == 0) {
    *thr = kNegInf;
    s.carry[0] = 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    for (int d = 0; d < ring.depth && d < n_steps; ++d) {
      stage_step(p, ring, s.ring + d * ring.slot_words, s.full + d, core, first + d);
    }
  }

  // The thread's words in a step: packet tid / B of it, nnz j of the packet,
  // and the shifts that decode its column id and value (decode's, without
  // its branches): an int16 id or a 2-byte value is the half j & 1 of its
  // word, a Q7 value the byte j & 3.
  const int j = tid % p.block, wf = p.block >> 5;
  const int row = (tid / p.block) * p.width;
  const bool wide = p.col_words == p.block;
  const int off_f = row + (j >> 5);
  const int off_c = row + wf + (wide ? j : (j >> 1));
  const int off_v = row + wf + p.col_words + (FMT == 0 ? j : (FMT == 3 ? (j >> 2) : (j >> 1)));
  const int flag_bit = j & 31;
  const int col_shl = wide ? 0 : 16 - (j & 1) * 16, col_shr = wide ? 0 : 16;
  const int val_shl = FMT == 3 ? 24 - (j & 3) * 8 : 16 - (j & 1) * 16;
  auto decode_raw = [&](const Raw& r, int* flag, int* c, float* val) {
    *flag = (r.flag_word >> flag_bit) & 1;
    *c = static_cast<int>(static_cast<unsigned>(r.col_word) << col_shl) >> col_shr;
    const unsigned w = static_cast<unsigned>(r.val_word);
    if (FMT == 0) {
      *val = __uint_as_float(w);
    } else if (FMT == 1) {
      *val = __uint_as_float((w << val_shl) & 0xffff0000u);
    } else if (FMT == 2) {
      *val = __fmul_rn(static_cast<float>(static_cast<int>(w << val_shl) >> 16),
                       3.0517578125e-05f);  // 2**-15
    } else {
      *val = __fmul_rn(static_cast<float>(static_cast<int>(w << val_shl) >> 24),
                       0.0078125f);         // 2**-7
    }
  };
  const int step_words = p.per_step * p.width;
  // The step's first word lies `shift` words into its slot's 16-byte span.
  int shift = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(p.words) >> 2) +
       static_cast<uintptr_t>((static_cast<long long>(core) * p.n_packets + first * p.per_step) *
                              p.width)) & 3u);
  int slot = 0;
  uint32_t parity = 0;
  auto next_raw = [&]() {
    wait_full(s.full + slot, parity);
    const int32_t* w = s.ring + slot * ring.slot_words + shift;
    const Raw r{w[off_f], w[off_c], w[off_v]};
    shift = (shift + step_words) & 3;
    if (++slot == ring.depth) {
      slot = 0;
      parity ^= 1u;
    }
    return r;
  };
  auto gather = [&](int c) {
    return static_cast<unsigned>(c) < static_cast<unsigned>(p.m)
               ? (p.x_in_smem ? s.x[c] : __ldg(p.x + c)) : 0.0f;
  };
  // The candidates of the step of parity `b` into the sorted scratchpad
  // (mq_walk's insert at one query); then the threshold copy.
  auto insert = [&](int b) {
    const int n = s.cand_n[b];
    for (int i = 0; i < n; ++i) {
      insert_sorted(s.acc_v, s.acc_r, k, s.cand_v[b * cap + i], s.cand_r[b * cap + i]);
    }
    s.cand_n[b] = 0;
    *thr = s.acc_v[k - 1];
  };
  float* heads = sp.heads + core * sp.n + split;
  int f, col;
  float v;
  decode_raw(next_raw(), &f, &col, &v);
  float xv = gather(col);
  int row0 = row_start;
  int spare = 0;  // thread 0: the slot of step i, the next to refill
  for (int i = 0; i < n_steps; ++i) {
    const int buf = i & 1;
    // The candidates of step i - 2, whose appends ended before step i - 1's
    // first barrier, while the other warps decode.
    if (tid == 0) insert(buf);
    float ps = __fmul_rn(v, xv);
    // The next step's nnz is decoded and its x gathered now.
    int f_next = 0;
    if (i + 1 < n_steps) {
      decode_raw(next_raw(), &f_next, &col, &v);
      xv = gather(col);
    }
    // ---- stage 2 ----
    const unsigned bits = __ballot_sync(0xffffffffu, f);
    unsigned* fw = s.fw + buf * 32;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, ps, d);
      if (lane >= d) ps = __fadd_rn(ps, y);
    }
    if (lane == 31) {
      fw[warp] = bits;
      s.warp_f[warp] = ps;
    }
    __syncthreads();  // publishes the warps' flag bits and totals
    if (tid == 0) {
      if (i + ring.depth < n_steps) {
        stage_step(p, ring, s.ring + spare * ring.slot_words, s.full + spare, core,
                   first + i + ring.depth);
      }
      if (++spare == ring.depth) spare = 0;
    }
    float tot = lane < nwarps ? s.warp_f[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, tot, d);
      if (lane >= d) tot = __fadd_rn(tot, y);
    }
    const unsigned count = lane < nwarps ? __popc(fw[lane]) : 0u;
    const int seg = __popc(bits & (0xffffffffu >> (31 - lane))) +
                    static_cast<int>(__reduce_add_sync(0xffffffffu, lane < warp ? count : 0u));
    const int s_last = static_cast<int>(__reduce_add_sync(0xffffffffu, count));
    const float offset = __shfl_sync(0xffffffffu, tot, (warp + 31) & 31);  // warp - 1's
    if (warp > 0) ps = __fadd_rn(ps, offset);
    // The nnz after this one opens a segment (the last nnz of the step
    // always closes one).
    const bool is_last =
        lane < 31 ? ((bits >> (lane + 1)) & 1u) != 0 : (warp + 1 == nwarps || (fw[warp + 1] & 1u));
    s.ps[tid] = ps;
    __syncthreads();  // publishes the prefixes
    // ---- stages 3 and 4 ----
    const bool at_head = head && i == 0;
    auto row_done = [&](int r, float c) {
      // A candidate: strictly above the scratchpad minimum, which may not
      // hold the previous step's candidates yet (a lower threshold).
      if (c > *thr) {
        const int at = atomicAdd(s.cand_n + buf, 1);
        s.cand_v[buf * cap + at] = c;
        s.cand_r[buf * cap + at] = r;
      }
    };
    if (tid == 0 && f) {
      // Segment 0 is empty: the carried row completes with its partial sum.
      if (at_head) {
        *heads = 0.0f;
      } else if (row0 >= 0) {
        row_done(row0, __fadd_rn(0.0f, s.carry[buf]));
      }
    }
    if (is_last) {
      // The segment's first nnz: the last flag bit at or before this one
      // (none for segment 0, whose prefix starts at 0.0).
      int start = 0;
      if (seg > 0) {
        unsigned m = bits & (0xffffffffu >> (31 - lane));
        int w = warp;
        while (m == 0) m = fw[--w];
        start = w * 32 + 31 - __clz(static_cast<int>(m));
      }
      const float base = start > 0 ? s.ps[start - 1] : 0.0f;
      const float piece = __fsub_rn(ps, base);
      const float c = __fadd_rn(piece, seg == 0 ? s.carry[buf] : 0.0f);
      const int r = row0 + seg;
      if (seg == s_last) {
        s.carry[buf ^ 1] = c;  // thread tb - 1: the open row goes on
      } else if (at_head && seg == 0) {
        *heads = piece;
      } else if (r >= 0) {
        row_done(r, c);
      }
    }
    row0 += s_last;
    f = f_next;
  }
  __syncthreads();
  if (tid == 0) {
    insert(0);  // the last two steps' candidates
    insert(1);
  }
  __syncthreads();
  const long long out = (static_cast<long long>(core) * sp.n + split) * k;
  for (int i = tid; i < k; i += tb) {
    sp.pad_v[out + i] = s.acc_v[i];
    sp.pad_r[out + i] = s.acc_r[i];
  }
  if (tid == tb - 1) sp.carries[core * sp.n + split] = s.carry[n_steps & 1];
}

// Block (core, split) walks one split, decoding its core's format (a
// template argument, so the decode has no branch); an empty split
// (trailing) holds no row, so its scratchpad stays empty.  Registers: held
// to 40, so 3 blocks of 512 threads share an SM, as in topk_spmv_mq1_kernel.
__global__ void __maxnreg__(40) topk_spmv_single_kernel(Params p, MqSplits sp, Ring ring) {
  const int core = blockIdx.x, split = blockIdx.y;
  const int32_t* b = sp.bounds + core * (sp.n + 1) + split;
  if (b[0] >= b[1]) {
    const long long out = (static_cast<long long>(core) * sp.n + split) * p.k;
    for (int i = threadIdx.x; i < p.k; i += blockDim.x) {
      sp.pad_v[out + i] = kNegInf;
      sp.pad_r[out + i] = p.n_rows;
    }
    return;
  }
  const int first = b[0], n_steps = b[1] - b[0], row = sp.head_row[core * sp.n + split];
  switch (core_fmt(p, core)) {
    case 0: single_walk<0>(p, sp, ring, core, split, first, n_steps, row, split > 0); break;
    case 1: single_walk<1>(p, sp, ring, core, split, first, n_steps, row, split > 0); break;
    case 2: single_walk<2>(p, sp, ring, core, split, first, n_steps, row, split > 0); break;
    default: single_walk<3>(p, sp, ring, core, split, first, n_steps, row, split > 0); break;
  }
}

// ---------------------------------------------------------------------------
// The multi-query walk at Q >= 2 (rows_walk): see the header.
// ---------------------------------------------------------------------------

// 16 bytes from global into shared memory, asynchronously (cp.async through
// the load path: a bulk copy of the tensor memory accelerator costs some 400
// cycles of its unit a copy, which bounds a walk of 1 KB packets).
__device__ inline void copy16(int32_t* to, const int32_t* from) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(shared_addr(to)), "l"(from)
               : "memory");
}

__device__ inline void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Until at most `pending` of this lane's newest copy groups are in flight.
__device__ inline void copy_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Its arguments: a struct of its own, so Params keeps its width.
struct RowsArgs {
  const float* x;           // (Q, M) f32
  const int32_t* words;     // (C, P, W) fused packet words
  const int32_t* bounds;    // (C, S+1) step bounds of each core's splits
  const int32_t* head_row;  // (C, S) slot of the row open at each split's start
  float* pad_v;             // (C, S, Q, k) each split's scratchpads (S = 1: the output)
  int32_t* pad_r;           // (C, S, Q, k)
  float* heads;             // (C, S, Q) head piece of each split after the first
  float* carries;           // (C, S, Q) open-row carry after each split's last step
  long long n_packets;      // P
  int n_cores, n_splits, width, m, nq;
  int block, per_step, col_words, fmt, k, n_rows;
  int packet_words;         // words of a packet the walk reads, from its first (W,
                            // less the next row's header word in a tagged stream)
  int q_width;              // queries a block carries
  // The launch's plan (rows_plan).
  int lanes;                // lanes a walker
  int q_lane;               // queries a lane: 2, or 4 above 32 queries a block at k <= 8
  int groups;               // walkers a warp
  int warps;                // warps a block
  int depth;                // ring slots a walker
  int slot_words;           // a slot: the 16-byte-aligned span around a packet
  int x_in_smem;
};

constexpr int kRowsMaxWarps = 16;
constexpr int kRowsMinWarps = 8;  // fewer walkers a warp before fewer warps than this
constexpr int kRowsBatch = 16;    // x values a lane reads together: 16 / q_lane nnz
constexpr size_t kRowsXBytes = 160 * 1024;  // x transposed above this stays in global memory
constexpr size_t kSmemLimit = 227 * 1024;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Floats a row of x transposed: q_lane a lane, and one unit of q_lane more
// so that the rows of a gather (and the stores of the fill) spread over the
// banks: an odd number of units (3 at one lane).
__host__ __device__ inline int rows_x_stride(int lanes, int q_lane) {
  return q_lane * (lanes + (lanes == 1 ? 2 : 1));
}

// Words of a walker's ring: its slots, padded to 4 words past a multiple of
// 32, so the walkers of a warp read their slots in different banks.
__host__ __device__ inline int rows_ring_words(const RowsArgs& a) {
  const int n = a.depth * a.slot_words;
  return n + ((36 - n % 32) % 32);
}

// The walk's shared memory: every walker's ring (first, so each slot is 16-
// byte aligned), each warp's decoded pairs ([32][walkers]), then x
// transposed.
__host__ __device__ inline size_t rows_smem_bytes(const RowsArgs& a) {
  const size_t walkers = size_t(a.warps) * a.groups;
  size_t n = align16(sizeof(int32_t) * walkers * rows_ring_words(a));
  n += align16(sizeof(int2) * walkers * 32);
  if (a.x_in_smem) n += align16(sizeof(float) * size_t(a.m + 1) * rows_x_stride(a.lanes, a.q_lane));
  return n;
}

// The layout: as many walkers a warp as the queries leave lanes for, and as
// many warps as shared memory holds, but fewer walkers a warp (more lanes
// each) where that keeps kRowsMinWarps warps a block to hide the latency of
// the walk's reads.
bool rows_plan(RowsArgs* a) {
  if (a->q_width < 1 || a->q_width > 64 || a->packet_words < 1) return false;
  // Four queries a lane halve the work a nnz costs a warp, where the
  // scratchpads of four queries fit in registers.
  a->q_lane = a->q_width > 32 && a->k <= 8 ? 4 : 2;
  int need = 1;  // lanes the chunk's queries need
  while (a->q_lane * need < a->q_width) need *= 2;
  a->slot_words = (4 * a->packet_words + 12 + 15) / 16 * 4;
  for (a->groups = 32 / need; a->groups >= 1; a->groups /= 2) {
    // Every lane of a warp serves a walker: the decode and the copies
    // spread over all of them, and a lane past the queries walks zeros.
    a->lanes = 32 / a->groups;
    a->x_in_smem =
        sizeof(float) * size_t(a->m + 1) * rows_x_stride(a->lanes, a->q_lane) <= kRowsXBytes;
    a->depth = a->groups == 1 ? 4 : 2;
    for (a->warps = kRowsMaxWarps; a->warps >= 1; --a->warps) {
      if (rows_smem_bytes(*a) <= kSmemLimit) break;
    }
    if (a->warps >= kRowsMinWarps || (a->groups == 1 && a->warps >= 1)) return true;
  }
  return false;
}

// The float of a total-order key (total_key's inverse).
__device__ inline float key_float(int key) {
  return __int_as_float(key < 0 ? key ^ 0x7fffffff : key);
}

// One query's scratchpad: K entries in registers as (total-order key, slot),
// sorted in lax.top_k order, and the admission threshold (the float of the
// last entry).  K = 0 keeps the k entries in the walker's slice of pad_v /
// pad_r instead.  Slots rise along the walk, so a row ranks after every
// entry of an equal key: the insertion compares keys alone, and a row that
// ranks after the last entry leaves the scratchpad as it is.
template <int K>
struct Pad {
  int key[K > 0 ? K : 1];
  int slot[K > 0 ? K : 1];
  float thr;
  float* gv;    // K = 0: the slice of pad_v
  int32_t* gr;  // K = 0: the slice of pad_r

  __device__ void init(bool valid, float* v, int32_t* r, int k, int n_rows) {
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        key[j] = total_key(kNegInf);
        slot[j] = n_rows;
      }
    } else {
      gv = v;
      gr = r;
      if (valid) {
        for (int j = 0; j < k; ++j) {
          gv[j] = kNegInf;
          gr[j] = n_rows;
        }
      }
    }
    // A query past the pass's end admits nothing.
    thr = valid ? kNegInf : __int_as_float(0x7f800000);
  }

  // Branch-free compare-and-shift: the row lands at the first entry it
  // ranks before, every entry from there moves down one, the last drops.
  __device__ void insert(float c, int r, int k) {
    int kc = total_key(c);
    if constexpr (K > 0) {
      bool moved = false;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        moved = moved || kc > key[j];
        const int tk = key[j], tr = slot[j];
        key[j] = moved ? kc : tk;
        slot[j] = moved ? r : tr;
        kc = moved ? tk : kc;
        r = moved ? tr : r;
      }
      thr = key_float(key[K - 1]);
    } else {
      if (kc <= total_key(gv[k - 1])) return;
      int j = k - 1;
      while (j > 0 && kc > total_key(gv[j - 1])) {
        gv[j] = gv[j - 1];
        gr[j] = gr[j - 1];
        --j;
      }
      gv[j] = c;
      gr[j] = r;
      thr = gv[k - 1];
    }
  }

  __device__ void store(float* v, int32_t* r, int k) const {
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j < k) {
          v[j] = key_float(key[j]);
          r[j] = slot[j];
        }
      }
    }
  }
};

// Block (walkers, query chunk): each walker, `lanes` lanes of a warp, walks
// one split of the table for the block's queries, lane l holding queries
// 2l and 2l + 1 of the chunk, from carry row head_row, carry 0.0 and empty
// scratchpads, and stores its scratchpads, head pieces and final carries
// in the (C, S, Q, k) and (C, S, Q) buffers for the fold.
//
// A walker takes its split packet by packet through its ring, and each
// packet 32 nnz at a time: its lanes decode the 32 nnz into (x row offset,
// value) pairs in shared memory, then every lane walks them in order, all
// walkers of the warp at the same nnz (no divergence but at the flag bits).
// The flag word marks where rows start: at a flag bit the row before it
// completes (stage 3) and, above the threshold, enters the scratchpads
// (stage 4).  A step ends every T packets: the open row's carry takes the
// step's piece.  The walkers of a warp keep in step (a finished one idles),
// so the warp's syncs see every lane.
template <int K, bool XS, int QL>
__device__ void rows_walk(const RowsArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lanes = a.lanes, depth = a.depth;
  const int grp = lane / lanes, at = lane - grp * lanes;  // lanes * groups = 32
  const int walker = warp * a.groups + grp;
  const int per_block = a.warps * a.groups;
  unsigned char* base = smem_raw;
  const int ring_words = rows_ring_words(a);
  int32_t* ring = reinterpret_cast<int32_t*>(base) + size_t(walker) * ring_words;
  base += align16(sizeof(int32_t) * size_t(per_block) * ring_words);
  // Pairs t and t + 1 (t even) of the walker side by side, the warp's
  // walkers side by side: pairs[(t >> 1) * 2 * groups + (t & 1)].
  int2* pairs = reinterpret_cast<int2*>(base) + warp * 32 * a.groups + 2 * grp;
  base += align16(sizeof(int2) * per_block * 32);
  float* xs = reinterpret_cast<float*>(base);
  const int stride = rows_x_stride(lanes, QL);

  const int q0 = blockIdx.y * a.q_width;
  const int nqc = min(a.q_width, a.nq - q0);
  if (XS) {
    // x (Q, M) into [m + 1][stride], consecutive threads along a query row
    // (coalesced reads); row m and the queries past the chunk are zeros.
    const int rows = a.m + 1;
    for (int i = tid; i < rows * stride; i += blockDim.x) {
      const int q = i / rows, c = i - q * rows;
      xs[c * stride + q] =
          (c < a.m && q < nqc) ? __ldg(a.x + static_cast<long long>(q0 + q) * a.m + c) : 0.0f;
    }
  }

  const int w = blockIdx.x * per_block + walker;
  const bool live = w < a.n_cores * a.n_splits;
  const int core = live ? w / a.n_splits : 0;
  const int split = live ? w - core * a.n_splits : 0;
  long long first = 0;  // the split's first packet
  int n_pk = 0, row = -1;
  if (live) {
    const int32_t* b = a.bounds + core * (a.n_splits + 1) + split;
    first = static_cast<long long>(b[0]) * a.per_step;
    n_pk = (b[1] - b[0]) * a.per_step;
    row = a.head_row[core * a.n_splits + split];
  }
  const int32_t* core_words = a.words + static_cast<long long>(core) * a.n_packets * a.width;
  const int32_t* pk_words = core_words + first * a.width;
  __syncthreads();
  // Packet p of the split into a ring slot: the walker's lanes copy the
  // 16-byte-aligned span around it, 16 bytes a copy; each lane's copies of a
  // packet are one group, and every lane commits one group a packet (empty
  // past the split's end), so D - 1 groups stay pending behind packet i.
  auto stage = [&](int p, int32_t* to) {
    if (live && p < n_pk) {
      const uintptr_t from = reinterpret_cast<uintptr_t>(pk_words + static_cast<long long>(p) * a.width);
      const int32_t* lo = reinterpret_cast<const int32_t*>(from & ~uintptr_t(15));
      const int n16 = static_cast<int>(((from + 4u * a.packet_words + 15u) & ~uintptr_t(15)) -
                                       (from & ~uintptr_t(15))) >> 4;
      for (int c = at; c < n16; c += lanes) copy16(to + 4 * c, lo + 4 * c);
    }
    copy_commit();
  };
  for (int d = 0; d < depth; ++d) stage(d, ring + d * a.slot_words);

  // The core's format (core_fmt's rule) and the decode's offsets.
  int fmt = a.fmt;
  if (live && fmt == kTag2) fmt = __ldg(core_words - 1) == 2 ? 2 : 1;
  const int wf = a.block >> 5;
  const bool wide = a.col_words == a.block;
  const int val_at = wf + a.col_words;
  auto decode_pair = [&](const int32_t* pk, int j) {
    const unsigned cw = static_cast<unsigned>(pk[wf + (wide ? j : (j >> 1))]);
    const int col = wide ? static_cast<int>(cw)
                         : static_cast<int>(static_cast<int16_t>((cw >> ((j & 1) * 16)) & 0xffffu));
    const unsigned vw =
        static_cast<unsigned>(pk[val_at + (fmt == 0 ? j : (fmt == 3 ? (j >> 2) : (j >> 1)))]);
    float v;
    switch (fmt) {
      case 0: v = __uint_as_float(vw); break;
      case 1: v = __uint_as_float(((vw >> ((j & 1) * 16)) & 0xffffu) << 16); break;
      case 2: v = __fmul_rn(static_cast<float>(static_cast<int16_t>((vw >> ((j & 1) * 16)) & 0xffffu)),
                            3.0517578125e-05f); break;  // 2**-15
      default: v = __fmul_rn(static_cast<float>(static_cast<int8_t>((vw >> ((j & 3) * 8)) & 0xffu)),
                             0.0078125f); break;       // 2**-7
    }
    // The byte offset of the id's row of x transposed (row m, zeros, for an
    // id out of range); with x in global memory, the id or -1.
    const int off = XS ? static_cast<int>(min(static_cast<unsigned>(col), static_cast<unsigned>(a.m))) *
                             stride * static_cast<int>(sizeof(float))
                       : (static_cast<unsigned>(col) < static_cast<unsigned>(a.m) ? col : -1);
    return make_int2(off, __float_as_int(v));
  };

  // The lane's QL queries.
  const char* x_lane = reinterpret_cast<const char*>(xs + QL * at);
  const long long out = (static_cast<long long>(core) * a.n_splits + split) * a.nq + q0 + QL * at;
  bool valid[QL];
  const float* xq[QL];
  Pad<K> pad[QL];
  float acc[QL], carry[QL];
#pragma unroll
  for (int j = 0; j < QL; ++j) {
    valid[j] = QL * at + j < nqc;
    xq[j] = a.x + static_cast<long long>(min(q0 + QL * at + j, a.nq - 1)) * a.m;
    pad[j].init(live && valid[j], a.pad_v + (out + j) * a.k, a.pad_r + (out + j) * a.k, a.k,
                a.n_rows);
    acc[j] = carry[j] = 0.0f;
  }
  bool opening = true;       // no flag bit yet in this step: the row it came in with is open
  bool at_head = split > 0;  // the split's first step, whose first row the fold completes
  const int groups = a.groups;

  const int n_iter =
      static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(n_pk)));
  int slot = 0;
  for (int i = 0; i < n_iter; ++i) {
    const bool act = i < n_pk;
    const int32_t* pk = nullptr;
    copy_wait(depth - 1);  // this lane's copies of packet i have landed
    __syncwarp();          // and every lane's
    if (act) {
      const int32_t* from = pk_words + static_cast<long long>(i) * a.width;
      pk = ring + slot * a.slot_words + ((reinterpret_cast<uintptr_t>(from) >> 2) & 3u);
    }
    for (int ch = 0; ch < wf; ++ch) {
      if (act) {
#pragma unroll 4
        for (int t = at; t < 32; t += lanes) {
          pairs[(t >> 1) * 2 * groups + (t & 1)] = decode_pair(pk, ch * 32 + t);
        }
      }
      __syncwarp();
      if (act) {
        // The 32 nnz in order, every walker of the warp at the same nnz, in
        // batches whose x reads are issued together, with no branch between
        // them.  At a flag bit the row before the nnz completes (stage 3)
        // and, above the threshold, enters the scratchpads (stage 4).
        const unsigned flags = static_cast<unsigned>(pk[ch]);
        constexpr int kBatch = kRowsBatch / QL;
#pragma unroll 1
        for (int h = 0; h < 32; h += kBatch) {
          float v[kBatch], xv[kBatch][QL];
          auto gather = [&](int u, int off, int value) {
            v[u] = __int_as_float(value);
            if constexpr (XS && QL == 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(x_lane + off);
              xv[u][0] = q4.x;
              xv[u][1] = q4.y;
              xv[u][2] = q4.z;
              xv[u][3] = q4.w;
            } else if constexpr (XS) {
              const float2 q2 = *reinterpret_cast<const float2*>(x_lane + off);
              xv[u][0] = q2.x;
              xv[u][1] = q2.y;
            } else {
#pragma unroll
              for (int j = 0; j < QL; ++j) xv[u][j] = off >= 0 ? __ldg(xq[j] + off) : 0.0f;
            }
          };
#pragma unroll
          for (int u = 0; u < kBatch; u += 2) {
            const int4 two = *reinterpret_cast<const int4*>(pairs + ((h + u) >> 1) * 2 * groups);
            gather(u, two.x, two.y);
            gather(u + 1, two.z, two.w);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if ((flags >> (h + u)) & 1u) {
              if (at_head && opening) {
#pragma unroll
                for (int j = 0; j < QL; ++j) {
                  if (valid[j]) a.heads[out + j] = acc[j];
                }
              } else if (row >= 0) {
#pragma unroll
                for (int j = 0; j < QL; ++j) {
                  const float c = __fadd_rn(acc[j], opening ? carry[j] : 0.0f);
                  if (c > pad[j].thr) pad[j].insert(c, row, a.k);
                }
              }
              ++row;
              opening = false;
#pragma unroll
              for (int j = 0; j < QL; ++j) acc[j] = 0.0f;
            }
#pragma unroll
            for (int j = 0; j < QL; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[u], xv[u][j]));
          }
        }
      }
      __syncwarp();
    }
    // Every lane of the walker has read the slot (the sync above): refill it.
    stage(i + depth, ring + slot * a.slot_words);
    if (++slot == depth) slot = 0;
    if (act) {
      if ((i + 1) % a.per_step == 0) {
        // The step ends: the open row carries its piece (plus the carry it
        // came in with when the step held no flag bit).
#pragma unroll
        for (int j = 0; j < QL; ++j) {
          carry[j] = __fadd_rn(acc[j], opening ? carry[j] : 0.0f);
          acc[j] = 0.0f;
        }
        opening = true;
        at_head = false;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < QL; ++j) {
      if (valid[j]) {
        a.carries[out + j] = carry[j];
        pad[j].store(a.pad_v + (out + j) * a.k, a.pad_r + (out + j) * a.k, a.k);
      }
    }
  }
}

template <int K, bool XS, int QL>
__global__ void __launch_bounds__(kRowsMaxWarps * 32) topk_spmv_rows_kernel(RowsArgs a) {
  rows_walk<K, XS, QL>(a);
}

// Scratchpad entries a walker keeps in registers for k (0: in pad_v / pad_r).
int rows_k(int k) { return k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 0; }

template <int K, bool XS, int QL = 2>
int rows_kernel_do(const RowsArgs& a, bool launch, dim3 grid, cudaStream_t stream,
                   int* blocks) {
  const auto kernel = topk_spmv_rows_kernel<K, XS, QL>;
  const size_t bytes = rows_smem_bytes(a);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!launch) {
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, a.warps * 32, bytes));
  }
  kernel<<<grid, a.warps * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The rows kernel for a's k and x placement: its launch on `grid`, or (not
// `launch`) the blocks an SM holds at once, into *blocks.
int rows_kernel(const RowsArgs& a, bool launch, dim3 grid, cudaStream_t stream, int* blocks) {
  const bool xs = a.x_in_smem != 0;
  if (a.q_lane == 4) {  // k <= 8 (rows_plan)
    return a.k <= 4 ? (xs ? rows_kernel_do<4, true, 4>(a, launch, grid, stream, blocks)
                          : rows_kernel_do<4, false, 4>(a, launch, grid, stream, blocks))
                    : (xs ? rows_kernel_do<8, true, 4>(a, launch, grid, stream, blocks)
                          : rows_kernel_do<8, false, 4>(a, launch, grid, stream, blocks));
  }
  switch (rows_k(a.k)) {
    case 4: return xs ? rows_kernel_do<4, true>(a, launch, grid, stream, blocks)
                      : rows_kernel_do<4, false>(a, launch, grid, stream, blocks);
    case 8: return xs ? rows_kernel_do<8, true>(a, launch, grid, stream, blocks)
                      : rows_kernel_do<8, false>(a, launch, grid, stream, blocks);
    case 16: return xs ? rows_kernel_do<16, true>(a, launch, grid, stream, blocks)
                       : rows_kernel_do<16, false>(a, launch, grid, stream, blocks);
    default: return xs ? rows_kernel_do<0, true>(a, launch, grid, stream, blocks)
                       : rows_kernel_do<0, false>(a, launch, grid, stream, blocks);
  }
}

// Dynamic shared memory of a launch whose layout takes bytes_of(x_in_smem)
// bytes; x stays in global memory when keeping it in shared memory would
// pass 160 KB.  0 when even that does not fit.
template <class BytesOf>
size_t plan_smem(BytesOf bytes_of, int* x_in_smem) {
  constexpr size_t kSmemLimit = 227 * 1024;
  *x_in_smem = 1;
  size_t bytes = bytes_of(1);
  if (bytes > 160 * 1024) {
    *x_in_smem = 0;
    bytes = bytes_of(0);
    if (bytes > kSmemLimit) return 0;
  }
  return bytes;
}

// A kernel's shared memory, planned, and its attribute set: the bytes, or 0
// when they do not fit.
template <class Kernel, class BytesOf>
size_t prepare(Kernel kernel, BytesOf bytes_of, int* x_in_smem) {
  const size_t bytes = plan_smem(bytes_of, x_in_smem);
  if (bytes == 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return err == cudaSuccess ? bytes : 0;
}

size_t accum_prepare(int tb, int m, int* x_in_smem) {
  return prepare(spmv_accum_kernel, [&](int in) { return accum_smem_bytes(tb, m, in); },
                 x_in_smem);
}

size_t single_prepare(int tb, int k, int m, const Ring& ring, int* x_in_smem) {
  return prepare(topk_spmv_single_kernel,
                 [&](int in) { return single_smem_bytes(tb, k, m, in, ring); }, x_in_smem);
}

// The one-query multi-query kernel's shared memory and its attribute.
size_t mq_prepare(int tb, int k, int m, int* x_in_smem) {
  return prepare(topk_spmv_mq1_kernel, [&](int in) { return mq_smem_bytes(tb, 1, k, m, in); },
                 x_in_smem);
}

bool bad_geometry(const Params& p) {
  const int tb = p.block * p.per_step;
  return tb % 32 != 0 || tb > 1024 || p.n_cores < 1 || p.k < 1 || p.q_chunk < 1 ||
         p.n_packets % p.per_step != 0 || p.n_packets < p.per_step;
}

Ring make_ring(int depth, int step_words) {
  return Ring{depth, step_words, (4 * step_words + 12 + 15) / 16 * 4};
}

bool bad_ring(const Params& p, const Ring& ring) {
  return ring.depth < 2 || ring.step_words < 1 || ring.step_words > p.per_step * p.width;
}

// The fold of S > 1 splits' scratchpads (no launch at S = 1) over n_cores x
// nq blocks of as many lanes (at most 32) as keep their lists within 48 KB
// of shared memory.
int launch_merge(const Params& p, const MqSplits& sp, cudaStream_t stream) {
  if (sp.n > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int lanes = max(1, min(32, 48 * 1024 / (8 * p.k)));
    topk_mq_merge_kernel<<<p.n_cores * p.nq, lanes, 8 * size_t(lanes) * p.k, stream>>>(p, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

Params topk_params(const float* x, const int32_t* words, float* out_v, int32_t* out_r,
                   int n_cores, long long n_packets, int width, int m, int nq, int q_chunk,
                   int block, int per_step, int col_words, int fmt, int k, int n_rows) {
  return Params{x, words, out_v, out_r, n_cores, n_packets, width, m, nq, q_chunk, block,
                per_step, col_words, fmt, k, n_rows, 1};
}

}  // namespace

// Single-query mode: out (C, k); bounds (C, S+1) and head_row (C, S) int32
// from the split table; pad_v / pad_r (C, S, 1, k) scratch (for S = 1 the
// output itself); heads and carries (C, S, 1) f32 scratch; a ring of
// `depth` steps of `step_words` words.  Launches the split walk and, for
// S > 1, the fold at one query.
extern "C" int bscsr_topk_spmv_launch(
    const float* x, const int32_t* words, float* out_v, int32_t* out_r,
    const int32_t* bounds, const int32_t* head_row, float* pad_v, int32_t* pad_r,
    float* heads, float* carries, int n_cores, int splits, long long n_packets, int width,
    int m, int block, int per_step, int col_words, int fmt, int k, int n_rows, int depth,
    int step_words, void* stream) {
  Params p = topk_params(x, words, out_v, out_r, n_cores, n_packets, width, m, 1, 1, block,
                         per_step, col_words, fmt, k, n_rows);
  const MqSplits sp{bounds, head_row, pad_v, pad_r, heads, carries, splits};
  const Ring ring = make_ring(depth, step_words);
  if (bad_geometry(p) || bad_ring(p, ring) || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tb = block * per_step;
  const size_t bytes = single_prepare(tb, k, m, ring, &p.x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_spmv_single_kernel<<<dim3(n_cores, splits), tb, bytes, s>>>(p, sp, ring);
  return launch_merge(p, sp, s);
}

// Multi-query mode at one query a block (topk_spmv_mq1_kernel): out (C, Q,
// k); bounds (C, S+1) and head_row (C, S) int32 from the split table; pad_v
// / pad_r (C, S, Q, k) scratch (for S = 1 the output itself); heads and
// carries (C, S, Q) f32 scratch.  Launches the split walk and, for S > 1,
// the fold.
extern "C" int bscsr_topk_spmv_multiquery_launch(
    const float* x, const int32_t* words, float* out_v, int32_t* out_r,
    const int32_t* bounds, const int32_t* head_row, float* pad_v, int32_t* pad_r,
    float* heads, float* carries, int n_cores, int splits, long long n_packets, int width,
    int m, int nq, int block, int per_step, int col_words, int fmt, int k, int n_rows,
    void* stream) {
  Params p = topk_params(x, words, out_v, out_r, n_cores, n_packets, width, m, nq, 1, block,
                         per_step, col_words, fmt, k, n_rows);
  const MqSplits sp{bounds, head_row, pad_v, pad_r, heads, carries, splits};
  if (bad_geometry(p) || splits < 1 || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tb = block * per_step;
  const size_t bytes = mq_prepare(tb, k, m, &p.x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_spmv_mq1_kernel<<<dim3(n_cores, splits, nq), tb, bytes, s>>>(p, sp);
  return launch_merge(p, sp, s);
}

// The rows walk's arguments and plan for a pass, or false when its
// geometry is refused or no layout fits.
bool rows_args(RowsArgs* a, const Params& p, const MqSplits& sp, int packet_words,
               int q_width) {
  *a = RowsArgs{p.x, p.words, sp.bounds, sp.head_row, sp.pad_v, sp.pad_r, sp.heads,
                sp.carries, p.n_packets, p.n_cores, sp.n, p.width, p.m, p.nq,
                p.block, p.per_step, p.col_words, p.fmt, p.k, p.n_rows, packet_words,
                q_width, 0, 0, 0, 0, 0, 0, 0};
  return !bad_geometry(p) && sp.n >= 1 && p.nq >= 1 && packet_words <= p.width &&
         rows_plan(a);
}

// Multi-query mode at Q >= 2 (topk_spmv_rows_kernel): as above, with
// q_width queries a block and packets of packet_words words (W, less the
// next row's header word in a tagged stream).  Launches the walk on a grid
// of (walkers / walkers a block, query chunks) and, for S > 1, the fold.
extern "C" int bscsr_topk_spmv_rows_launch(
    const float* x, const int32_t* words, float* out_v, int32_t* out_r,
    const int32_t* bounds, const int32_t* head_row, float* pad_v, int32_t* pad_r,
    float* heads, float* carries, int n_cores, int splits, long long n_packets, int width,
    int packet_words, int m, int nq, int q_width, int block, int per_step, int col_words,
    int fmt, int k, int n_rows, void* stream) {
  const Params p = topk_params(x, words, out_v, out_r, n_cores, n_packets, width, m, nq, 1,
                               block, per_step, col_words, fmt, k, n_rows);
  const MqSplits sp{bounds, head_row, pad_v, pad_r, heads, carries, splits};
  RowsArgs a;
  if (!rows_args(&a, p, sp, packet_words, q_width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = a.warps * a.groups;
  const dim3 grid((n_cores * splits + per_block - 1) / per_block, (nq + q_width - 1) / q_width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = rows_kernel(a, true, grid, s, nullptr);
  if (err != 0) return err;
  return launch_merge(p, sp, s);
}

// Accumulate mode: out (C, n_rows) f32, zero-filled by the caller; bounds
// (C, S+1) and head_row (C, S) int32 from the split table; heads and
// carries (C, S) f32 scratch.  Launches the split walk and, for S > 1, the
// fix-up.
extern "C" int bscsr_spmv_launch(const float* x, const int32_t* words, float* out,
                                 const int32_t* bounds, const int32_t* head_row,
                                 float* heads, float* carries, int n_cores, int splits,
                                 long long n_packets, int width, int m, int block,
                                 int per_step, int col_words, int fmt, int n_rows,
                                 void* stream) {
  Params p = topk_params(x, words, out, nullptr, n_cores, n_packets, width, m, 1, 1, block,
                         per_step, col_words, fmt, 1, n_rows);
  const Splits sp{bounds, head_row, heads, carries, splits};
  if (bad_geometry(p) || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tb = block * per_step;
  const size_t bytes = accum_prepare(tb, m, &p.x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  spmv_accum_kernel<<<dim3(n_cores, splits), tb, bytes, s>>>(p, sp);
  if (splits > 1) spmv_fixup_kernel<<<n_cores, 32, 0, s>>>(p, sp);
  return static_cast<int>(cudaGetLastError());
}

// Accumulate blocks of T*B threads that one SM holds at once, for an x of
// width m (the occupancy calculator; the caller sizes S from it).
extern "C" int bscsr_spmv_resident_blocks(int block, int per_step, int m, int* blocks) {
  const int tb = block * per_step;
  int x_in_smem = 0;
  if (tb % 32 != 0 || tb > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = accum_prepare(tb, m, &x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, spmv_accum_kernel, tb, bytes));
}

// Single-query blocks of T*B threads that one SM holds at once, for an x of
// width m, k entries a scratchpad and a ring of `depth` steps of
// `step_words` words.
extern "C" int bscsr_topk_spmv_resident_blocks(int block, int per_step, int m, int k,
                                               int depth, int step_words, int* blocks) {
  const int tb = block * per_step;
  const Ring ring = make_ring(depth, step_words);
  int x_in_smem = 0;
  if (tb % 32 != 0 || tb > 1024 || k < 1 || depth < 2 || step_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = single_prepare(tb, k, m, ring, &x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, topk_spmv_single_kernel, tb, bytes));
}

// One-query multi-query blocks of T*B threads that one SM holds at once,
// for an x of width m and k entries a scratchpad.
extern "C" int bscsr_topk_spmv_mq_resident_blocks(int block, int per_step, int m, int k,
                                                  int* blocks) {
  const int tb = block * per_step;
  int x_in_smem = 0;
  if (tb % 32 != 0 || tb > 1024 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = mq_prepare(tb, k, m, &x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, topk_spmv_mq1_kernel, tb, bytes));
}

// The rows walk's blocks that one SM holds at once and walkers a block, for
// q_width queries a block, an x of width m, k entries a scratchpad and
// packets of packet_words words.
extern "C" int bscsr_topk_spmv_rows_resident(int block, int per_step, int packet_words, int m,
                                             int q_width, int k, int* blocks, int* walkers) {
  RowsArgs a{};
  a.block = block;
  a.per_step = per_step;
  a.packet_words = packet_words;
  a.m = m;
  a.q_width = q_width;
  a.k = k;
  const int tb = block * per_step;
  if (tb % 32 != 0 || tb > 1024 || k < 1 || !rows_plan(&a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *walkers = a.warps * a.groups;
  return rows_kernel(a, false, dim3(1), nullptr, blocks);
}
