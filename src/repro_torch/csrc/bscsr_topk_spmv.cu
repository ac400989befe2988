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
// In the single-query kernel stages 1-3 are one template (walk) with a
// stage-4 struct plugged in; the multi-query and accumulate kernels have
// their own walks (mq_walk, accum_walk), with the same arithmetic.  The next
// step's words are loaded into registers before the current step's scans,
// hiding part of the load latency.
//
// The stage-3 carry crosses packet boundaries, so the single-query kernel
// walks a core's packets in order with ONE block (the TPU's sequential grid
// axis becomes a loop inside the block).  A step costs about 1.2 us of scan
// latency and 11 barriers, not bytes, so with c = 32 cores on 132 SMs a
// one-block walk reaches a few percent of the byte bound.  The other two
// kernels split each core's stream among blocks.
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
// same shuffle tree as the top-k walk (same f32 association, same bits) and
// double-buffers the carry, so a step costs 4 barriers instead of 11, and
// it gathers x a step ahead.  The likely next limit is the bytes in
// flight (PERF.md): each thread holds one step of words in registers, so 3
// blocks of 512 threads per SM (about 40 registers each) keep about 12 KB per SM
// in flight, which at HBM latency sustains well under 3.35 TB/s; a deeper
// ring of steps in shared memory (cp.async) is the next step.
//
// The multi-query kernel (topk_spmv_mq1_kernel or topk_spmv_mq_split_kernel,
// then topk_mq_merge_kernel) replaced a one-block walk per (core, chunk of 8
// queries) that reached 0.5-1.7% of its bounds: 32 of 132 SMs worked at
// Q <= 8, and each query of a chunk ran its own block scans, about 53
// barriers a step at 8 queries.  Latency
// per step bounds it, not bytes (Q = 1) or f32 operations (Q = 64).  It walks
// the accumulate kernel's split table on a grid of (core, split, query
// chunk), S from the occupancy calculator over cores x chunks (one wave),
// and cuts every walk at e_c.  Each block starts from carry 0.0 and empty
// scratchpads; a split after the first keeps the head piece of the row open
// at its first step (not a candidate there) and hands it, with every
// split's final carry, to (C, S, Q) side buffers, and its scratchpads to
// (C, S, Q, k) ones.  Exactness: a walk admits a row when strictly above the
// scratchpad minimum at the start of the step and ranks in lax.top_k order;
// slots rise along the walk, no candidate scores -0.0 (stage 3 adds +0.0 or
// a carry that is never -0.0) and NaN is never admitted, so "above the
// step-start minimum" is "ranks before the current k-th entry", and a walk's
// final scratchpad is the top k of the rows it completed.  The single walk's
// is then the top k of (the fold of splits before i, split i's head row,
// split i's own top k), which the fold kernel computes in split order: head
// score = head piece + carry of split i-1 (the single walk's one f32
// addition for that row), admitted when > the fold's minimum (the single
// walk's threshold at that step), then an in-order merge of split i's
// list.  Every S gives the bits of S = 1.  Within a step, stage 2 is one
// scan pass for all queries of the block (mq_walk), so a step costs 3
// barriers at any chunk width.
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

struct Smem {
  float* x;         // q_chunk * m (only when x_in_smem)
  int* flag;        // TB
  float* ps;        // TB
  float* start;     // TB + 1: prefix before each segment's first nnz
  int* warp_i;      // 32
  float* warp_f;    // 32
  float* acc_v;     // q_chunk * k, sorted by (total order desc, slot asc)
  int* acc_r;       // q_chunk * k
  float* carry;     // q_chunk: open-row partial sum per query
  float* cand_v;    // q_chunk * (TB + 1)
  int* cand_r;      // q_chunk * (TB + 1)
  int* cand_n;      // q_chunk
  int* misc;        // [0] carry row, [1] s_last
};

__host__ __device__ inline size_t align8(size_t n) { return (n + 7) & ~size_t(7); }

__host__ __device__ inline size_t smem_bytes(int tb, int q_chunk, int k, int m,
                                             int x_in_smem) {
  size_t n = 0;
  if (x_in_smem) n += align8(sizeof(float) * size_t(q_chunk) * m);
  n += align8(sizeof(int) * tb) + align8(sizeof(float) * tb);
  n += align8(sizeof(float) * (tb + 1)) + 2 * align8(sizeof(int) * 32);
  n += 2 * align8(sizeof(float) * size_t(q_chunk) * k) + align8(sizeof(float) * q_chunk);
  n += 2 * align8(sizeof(float) * size_t(q_chunk) * (tb + 1));
  n += align8(sizeof(int) * q_chunk) + align8(sizeof(int) * 4);
  return n;
}

__device__ inline Smem carve(unsigned char* base, int tb, int q_chunk, int k, int m,
                             int x_in_smem) {
  Smem s;
  unsigned char* p = base;
  auto take = [&p](size_t bytes) { unsigned char* r = p; p += align8(bytes); return r; };
  s.x = x_in_smem ? reinterpret_cast<float*>(take(sizeof(float) * size_t(q_chunk) * m))
                  : nullptr;
  s.flag = reinterpret_cast<int*>(take(sizeof(int) * tb));
  s.ps = reinterpret_cast<float*>(take(sizeof(float) * tb));
  s.start = reinterpret_cast<float*>(take(sizeof(float) * (tb + 1)));
  s.warp_i = reinterpret_cast<int*>(take(sizeof(int) * 32));
  s.warp_f = reinterpret_cast<float*>(take(sizeof(float) * 32));
  s.acc_v = reinterpret_cast<float*>(take(sizeof(float) * size_t(q_chunk) * k));
  s.acc_r = reinterpret_cast<int*>(take(sizeof(int) * size_t(q_chunk) * k));
  s.carry = reinterpret_cast<float*>(take(sizeof(float) * q_chunk));
  s.cand_v = reinterpret_cast<float*>(take(sizeof(float) * size_t(q_chunk) * (tb + 1)));
  s.cand_r = reinterpret_cast<int*>(take(sizeof(int) * size_t(q_chunk) * (tb + 1)));
  s.cand_n = reinterpret_cast<int*>(take(sizeof(int) * q_chunk));
  s.misc = reinterpret_cast<int*>(take(sizeof(int) * 4));
  return s;
}

// Inclusive block-wide scans (blockDim.x a multiple of 32, at most 1024).
__device__ inline int block_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  __syncthreads();
  return v;
}

__device__ inline float block_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = __fadd_rn(v, y);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? warp_tot[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      float y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = __fadd_rn(w, y);
    }
    if (lane < nwarps) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = __fadd_rn(v, warp_tot[warp - 1]);
  __syncthreads();
  return v;
}

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

__device__ inline Raw load_raw(const Params& p, int core, long long step, int tid) {
  const long long pkt = step * p.per_step + tid / p.block;
  const int j = tid % p.block;
  const int32_t* row = p.words + (static_cast<long long>(core) * p.n_packets + pkt) * p.width;
  const int wf = p.block >> 5;
  Raw r;
  r.flag_word = __ldg(row + (j >> 5));
  r.col_word = __ldg(row + wf + (p.col_words == p.block ? j : (j >> 1)));
  const int vj = p.fmt == 0 ? j : (p.fmt == 3 ? (j >> 2) : (j >> 1));  // kTag2: 2 bytes
  r.val_word = __ldg(row + wf + p.col_words + vj);
  return r;
}

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

// Stage 4 of the top-k kernels: a k-entry scratchpad per query.
struct TopkStage {
  __device__ void init(const Params& p, Smem& s, int tid, int tb, int nq) const {
    for (int i = tid; i < nq * p.k; i += tb) {
      s.acc_v[i] = kNegInf;
      s.acc_r[i] = p.n_rows;
    }
  }
  // A row that completed in this step: appended to the query's candidate
  // list when strictly above the scratchpad minimum at the start of the step
  // (the scratchpad changes only in end_step).
  __device__ void row_done(const Params& p, Smem& s, int core, int q, int r,
                           float c, int tb) const {
    if (c > s.acc_v[q * p.k + p.k - 1]) {
      const int at = atomicAdd(s.cand_n + q, 1);
      s.cand_v[q * (tb + 1) + at] = c;
      s.cand_r[q * (tb + 1) + at] = r;
    }
  }
  // Each query's candidate list into its sorted scratchpad.
  __device__ void end_step(const Params& p, Smem& s, int tid, int tb, int nq) const {
    if (tid >= nq) return;
    const int k = p.k;
    float* av = s.acc_v + tid * k;
    int* ar = s.acc_r + tid * k;
    const float* cv = s.cand_v + tid * (tb + 1);
    const int* cr = s.cand_r + tid * (tb + 1);
    const int n = s.cand_n[tid];
    for (int i = 0; i < n; ++i) {
      const float c = cv[i];
      const int r = cr[i];
      const int kc = total_key(c);
      if (!ranks_before(kc, r, total_key(av[k - 1]), ar[k - 1])) continue;
      int pos = k - 1;
      while (pos > 0 && ranks_before(kc, r, total_key(av[pos - 1]), ar[pos - 1])) {
        av[pos] = av[pos - 1];
        ar[pos] = ar[pos - 1];
        --pos;
      }
      av[pos] = c;
      ar[pos] = r;
    }
    s.cand_n[tid] = 0;
  }
  __device__ void finish(const Params& p, Smem& s, int core, int q0, int tid, int tb,
                         int nq) const {
    for (int i = tid; i < nq * p.k; i += tb) {
      const int q = i / p.k;
      const long long o = (static_cast<long long>(core) * p.nq + q0 + q) * p.k + i % p.k;
      p.out_v[o] = s.acc_v[i];
      p.out_r[o] = s.acc_r[i];
    }
  }
};

// Stages 1-3, shared by every kernel: one block walks core `core`'s packets
// in order for queries q0 .. q0+nq-1 and hands each completed row to the
// stage.
template <typename Stage>
__device__ void walk(const Params& p, int core, int q0, int nq, const Stage& stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  Smem s = carve(smem_raw, tb, p.q_chunk, p.k, p.m, p.x_in_smem);

  if (p.x_in_smem) {
    const float* xs = p.x + static_cast<long long>(q0) * p.m;
    for (int i = tid; i < nq * p.m; i += tb) s.x[i] = xs[i];
  }
  stage.init(p, s, tid, tb, nq);
  if (tid < nq) {
    s.carry[tid] = 0.0f;
    s.cand_n[tid] = 0;
  }
  if (tid == 0) s.misc[0] = -1;
  __syncthreads();

  const long long n_steps = p.n_packets / p.per_step;
  const int j = tid % p.block;
  const int fmt = core_fmt(p, core);
  Raw next = load_raw(p, core, 0, tid);
  for (long long step = 0; step < n_steps; ++step) {
    const Raw cur = next;
    if (step + 1 < n_steps) next = load_raw(p, core, step + 1, tid);
    int f, col;
    float v;
    decode(p, fmt, cur, j, &f, &col, &v);
    const bool oob = col < 0 || col >= p.m;
    s.flag[tid] = f;
    const int seg = block_scan(f, s.warp_i);   // barriers publish s.flag
    if (tid == tb - 1) s.misc[1] = seg;
    __syncthreads();
    const int s_last = s.misc[1];
    const int row0 = s.misc[0];
    const bool is_last = tid == tb - 1 || s.flag[tid + 1] != 0;

    for (int q = 0; q < nq; ++q) {
      float xv = 0.0f;
      if (!oob) {
        xv = p.x_in_smem ? s.x[q * p.m + col]
                         : __ldg(p.x + static_cast<long long>(q0 + q) * p.m + col);
      }
      const float ps = block_scan(__fmul_rn(v, xv), s.warp_f);
      s.ps[tid] = ps;
      __syncthreads();
      if (f) s.start[seg] = tid > 0 ? s.ps[tid - 1] : 0.0f;
      __syncthreads();
      const float part = s.carry[q];
      if (tid == 0 && f && row0 >= 0) {
        // Segment 0 is empty: the carried row completes with its partial sum.
        stage.row_done(p, s, core, q, row0, __fadd_rn(0.0f, part), tb);
      }
      float carry_out = 0.0f;  // set by the last thread: its segment is s_last
      if (is_last) {
        const float base = seg == 0 ? 0.0f : s.start[seg];
        const float c = __fadd_rn(__fsub_rn(ps, base), seg == 0 ? part : 0.0f);
        if (seg < s_last) {
          const int r = row0 + seg;
          if (r >= 0) stage.row_done(p, s, core, q, r, c, tb);
        } else {
          carry_out = c;
        }
      }
      __syncthreads();  // every read of this query's carry and prefixes is done
      if (tid == tb - 1) s.carry[q] = carry_out;
    }

    stage.end_step(p, s, tid, tb, nq);
    if (tid == 0) s.misc[0] = row0 + s_last;
    __syncthreads();
  }
  stage.finish(p, s, core, q0, tid, tb, nq);
}

__global__ void topk_spmv_kernel(Params p) { walk(p, blockIdx.x, 0, 1, TopkStage{}); }

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
// with 3 barriers instead of 6 plus 2; the prefixes are published by the
// scan's last barrier; the carry and carry row are double-buffered, so a
// step costs 4 barriers where the top-k walk costs 11.  The words are
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

// The multi-query walk's shared memory for qc queries a block: x (when it
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

// Stages 1-4 of the multi-query kernel: block (core, split, chunk) walks
// n_steps steps of its core from `first` for queries q0 .. q0+nq-1, from
// carry row `row_start`, carry 0.0 and empty scratchpads, and stores each
// query's scratchpad in its slice of pad_v / pad_r.  In head mode (a split
// after the first, which starts at a flagged step) the row open at `first`
// completes in that step, but only the fold knows its carry: its head piece
// goes to `heads`, and every split's final carry to `carries`.
//
// Stage 2 is one scan pass: every query's product goes up block_scan's warp
// shuffle tree in the same loop, the warp totals are scanned by one warp per
// column (the flag counts, then each query), and each thread adds its warp's
// offset: block_scan's association for every query, so the bits of the
// one-block walk.  The flags are counted from a warp ballot.  A segment's
// start prefix is read at the nnz before its first, found in the ballots, so
// no array of starts is published.  A step's candidates are inserted two
// steps later (lists double-buffered by step parity), by one thread per
// query while the other warps decode, so no barrier waits for them:
// admission then compares with a minimum that may not hold the previous
// step's candidates yet, a lower threshold that admits more candidates, and
// insertion ranks each one exactly against the current k-th entry, so the
// scratchpad ends the same.  Admission reads a copy of the minimum that the
// inserting thread stores once its insertions are done (`thr`), never the
// list that thread is writing.  One set of three barriers a step (warp
// totals, scanned totals, prefixes) serves every query of the chunk, where
// the one-block walk spends 4 + 6 per query + 1.
template <int QC>
__device__ void mq_walk(const Params& p, const MqSplits& sp, int core, int split, int q0,
                        int nq, long long first, int n_steps, int row_start, bool head) {
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
    // without a shuffle tree; the products keep block_scan's tree.
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
template <int QC>
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
  mq_walk<QC>(p, sp, core, split, q0, nq, b[0], b[1] - b[0],
              sp.head_row[core * sp.n + split], split > 0);
}

// Registers: a block of one query is held to 40, so 3 blocks of 512 threads
// share an SM (S = 12 at c = 32 instead of 8); a wider chunk may use 64,
// which still launches 1024 threads.
__global__ void __maxnreg__(40) topk_spmv_mq1_kernel(Params p, MqSplits sp) {
  mq_split<1>(p, sp);
}

template <int QC>
__global__ void __launch_bounds__(1024) topk_spmv_mq_split_kernel(Params p, MqSplits sp) {
  mq_split<QC>(p, sp);
}

template <int QC>
auto mq_kernel() {
  if constexpr (QC == 1) {
    return topk_spmv_mq1_kernel;
  } else {
    return topk_spmv_mq_split_kernel<QC>;
  }
}

// The fold: one warp per (core, query) joins the splits' scratchpads in
// order, in shared memory.  The head row of each non-empty split i > 0 scores
// head piece + the carry of split i - 1 (the single walk's stage-3 addition
// for it), is admitted when > the fold's minimum (the single walk's
// threshold at that step) and inserted; then the top k of the fold and split
// i's sorted list are merged in place from the back, once it is known how
// many entries each list gives.
__global__ void topk_mq_merge_kernel(Params p, MqSplits sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = p.k, n_splits = sp.n, lane = threadIdx.x;
  const int core = blockIdx.x / p.nq, q = blockIdx.x % p.nq;
  float* fv = reinterpret_cast<float*>(smem_raw);
  int* fr = reinterpret_cast<int*>(fv + k);
  float* iv = reinterpret_cast<float*>(fr + k);
  int* ir = reinterpret_cast<int*>(iv + k);
  auto at = [&](int i) { return (static_cast<long long>(core) * n_splits + i) * p.nq + q; };
  for (int j = lane; j < k; j += 32) {
    fv[j] = sp.pad_v[at(0) * k + j];
    fr[j] = sp.pad_r[at(0) * k + j];
  }
  const int32_t* b = sp.bounds + core * (n_splits + 1);
  for (int i = 1; i < n_splits && b[i] < b[i + 1]; ++i) {
    for (int j = lane; j < k; j += 32) {
      iv[j] = sp.pad_v[at(i) * k + j];
      ir[j] = sp.pad_r[at(i) * k + j];
    }
    __syncwarp();
    if (lane == 0) {
      const int r = sp.head_row[core * n_splits + i];
      const float c = __fadd_rn(sp.heads[at(i)], sp.carries[at(i - 1)]);
      if (r >= 0 && c > fv[k - 1]) insert_sorted(fv, fr, k, c, r);
      int na = 0, ni = 0;  // entries of the top k from the fold and from split i
      while (na + ni < k) {
        if (ranks_before(total_key(iv[ni]), ir[ni], total_key(fv[na]), fr[na])) {
          ++ni;
        } else {
          ++na;
        }
      }
      for (int o = k - 1, a = na - 1, n = ni - 1; o >= 0; --o) {
        if (a >= 0 &&
            (n < 0 || ranks_before(total_key(iv[n]), ir[n], total_key(fv[a]), fr[a]))) {
          fv[o] = fv[a];
          fr[o] = fr[a];
          --a;
        } else {
          fv[o] = iv[n];
          fr[o] = ir[n];
          --n;
        }
      }
    }
    __syncwarp();
  }
  const long long o = (static_cast<long long>(core) * p.nq + q) * k;
  for (int j = lane; j < k; j += 32) {
    p.out_v[o + j] = fv[j];
    p.out_r[o + j] = fr[j];
  }
}

// The kernels that launch() serves; the multi-query kernel has its own.
enum class Kind { kTopk, kAccumulate };

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

size_t plan_smem(Kind kind, int tb, int q_chunk, int k, int m, int* x_in_smem) {
  return plan_smem(
      [&](int in_smem) {
        return kind == Kind::kAccumulate ? accum_smem_bytes(tb, m, in_smem)
                                         : smem_bytes(tb, q_chunk, k, m, in_smem);
      },
      x_in_smem);
}

const void* kernel_of(Kind kind) {
  return kind == Kind::kTopk ? reinterpret_cast<const void*>(topk_spmv_kernel)
                             : reinterpret_cast<const void*>(spmv_accum_kernel);
}

bool bad_geometry(const Params& p) {
  const int tb = p.block * p.per_step;
  return tb % 32 != 0 || tb > 1024 || p.n_cores < 1 || p.k < 1 || p.q_chunk < 1 ||
         p.n_packets % p.per_step != 0 || p.n_packets < p.per_step;
}

int launch(Kind kind, Params p, const Splits& sp, cudaStream_t stream) {
  const int tb = p.block * p.per_step;
  if (bad_geometry(p) || (kind == Kind::kAccumulate && sp.n < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = plan_smem(kind, tb, p.q_chunk, p.k, p.m, &p.x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of(kind), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kind == Kind::kTopk) {
    topk_spmv_kernel<<<p.n_cores, tb, bytes, stream>>>(p);
  } else {
    spmv_accum_kernel<<<dim3(p.n_cores, sp.n), tb, bytes, stream>>>(p, sp);
    if (sp.n > 1) spmv_fixup_kernel<<<p.n_cores, 32, 0, stream>>>(p, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

// The multi-query kernel's shared memory and its attribute, for QC queries
// a block: the bytes, or 0 when they do not fit.
template <int QC>
size_t mq_prepare(int tb, int k, int m, int* x_in_smem) {
  const size_t bytes =
      plan_smem([&](int in_smem) { return mq_smem_bytes(tb, QC, k, m, in_smem); }, x_in_smem);
  if (bytes == 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      mq_kernel<QC>(), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return err == cudaSuccess ? bytes : 0;
}

template <int QC>
int launch_mq(Params p, const MqSplits& sp, cudaStream_t stream) {
  const int tb = p.block * p.per_step;
  const size_t bytes = mq_prepare<QC>(tb, p.k, p.m, &p.x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.n_cores, sp.n, (p.nq + p.q_chunk - 1) / p.q_chunk);
  const auto kernel = mq_kernel<QC>();
  kernel<<<grid, tb, bytes, stream>>>(p, sp);
  if (sp.n > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_mq_merge_kernel<<<p.n_cores * p.nq, 32, 16 * size_t(p.k), stream>>>(p, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

// The template width of a chunk of q_chunk queries (0: more than 8).
int qc_of(int q_chunk) {
  return q_chunk <= 1 ? 1 : q_chunk <= 2 ? 2 : q_chunk <= 4 ? 4 : q_chunk <= 8 ? 8 : 0;
}

Params topk_params(const float* x, const int32_t* words, float* out_v, int32_t* out_r,
                   int n_cores, long long n_packets, int width, int m, int nq, int q_chunk,
                   int block, int per_step, int col_words, int fmt, int k, int n_rows) {
  return Params{x, words, out_v, out_r, n_cores, n_packets, width, m, nq, q_chunk, block,
                per_step, col_words, fmt, k, n_rows, 1};
}

}  // namespace

extern "C" int bscsr_topk_spmv_launch(const float* x, const int32_t* words, float* out_v,
                                      int32_t* out_r, int n_cores, long long n_packets,
                                      int width, int m, int nq, int q_chunk, int block,
                                      int per_step, int col_words, int fmt, int k,
                                      int n_rows, void* stream) {
  return launch(Kind::kTopk,
                topk_params(x, words, out_v, out_r, n_cores, n_packets, width, m, 1, 1,
                            block, per_step, col_words, fmt, k, n_rows),
                Splits{}, static_cast<cudaStream_t>(stream));
}

// Multi-query mode: out (C, Q, k); bounds (C, S+1) and head_row (C, S) int32
// from the split table; pad_v / pad_r (C, S, Q, k) scratch (for S = 1 the
// output itself); heads and carries (C, S, Q) f32 scratch.  Launches the
// split walk and, for S > 1, the fold.
extern "C" int bscsr_topk_spmv_multiquery_launch(
    const float* x, const int32_t* words, float* out_v, int32_t* out_r,
    const int32_t* bounds, const int32_t* head_row, float* pad_v, int32_t* pad_r,
    float* heads, float* carries, int n_cores, int splits, long long n_packets, int width,
    int m, int nq, int q_chunk, int block, int per_step, int col_words, int fmt, int k,
    int n_rows, void* stream) {
  const Params p = topk_params(x, words, out_v, out_r, n_cores, n_packets, width, m, nq,
                               q_chunk, block, per_step, col_words, fmt, k, n_rows);
  const MqSplits sp{bounds, head_row, pad_v, pad_r, heads, carries, splits};
  if (bad_geometry(p) || splits < 1 || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qc_of(q_chunk)) {
    case 1: return launch_mq<1>(p, sp, s);
    case 2: return launch_mq<2>(p, sp, s);
    case 4: return launch_mq<4>(p, sp, s);
    case 8: return launch_mq<8>(p, sp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return launch(Kind::kAccumulate,
                topk_params(x, words, out, nullptr, n_cores, n_packets, width, m, 1, 1,
                            block, per_step, col_words, fmt, 1, n_rows),
                Splits{bounds, head_row, heads, carries, splits},
                static_cast<cudaStream_t>(stream));
}

// Accumulate blocks of T*B threads that one SM holds at once, for an x of
// width m (the occupancy calculator; the caller sizes S from it).
extern "C" int bscsr_spmv_resident_blocks(int block, int per_step, int m, int* blocks) {
  const int tb = block * per_step;
  int x_in_smem = 0;
  const size_t bytes = plan_smem(Kind::kAccumulate, tb, 1, 1, m, &x_in_smem);
  if (tb % 32 != 0 || tb > 1024 || bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(spmv_accum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, spmv_accum_kernel, tb, bytes));
}

// Multi-query blocks of T*B threads, q_chunk queries each, that one SM holds
// at once, for an x of width m and k entries a scratchpad.
template <int QC>
int mq_resident(int tb, int m, int k, int* blocks) {
  int x_in_smem = 0;
  const size_t bytes = mq_prepare<QC>(tb, k, m, &x_in_smem);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mq_kernel<QC>(), tb, bytes));
}

extern "C" int bscsr_topk_spmv_mq_resident_blocks(int block, int per_step, int m,
                                                  int q_chunk, int k, int* blocks) {
  const int tb = block * per_step;
  if (tb % 32 != 0 || tb > 1024 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (qc_of(q_chunk)) {
    case 1: return mq_resident<1>(tb, m, k, blocks);
    case 2: return mq_resident<2>(tb, m, k, blocks);
    case 4: return mq_resident<4>(tb, m, k, blocks);
    case 8: return mq_resident<8>(tb, m, k, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
