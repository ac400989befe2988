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
// The accumulate kernel reads the same stream and writes one f32 per slot
// (C x n_rows), so it is bound by bytes; for a graph operator x is too wide
// for shared memory and is gathered from global memory (through L2).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// one pass must read every stream word once, ~4.1 bytes per stored nnz in
// BF16 with int16 column ids, so a single query is bound by bytes.  A batch
// adds 2 flops per nnz per query, so from about Q = 32 on the f32 rate bounds
// it instead.  wgmma has no role: the work is a gather and a scan.
//
// Design.  The stage-3 row carry crosses packet boundaries, so a core's
// packets are walked in order by ONE thread block (the TPU's sequential grid
// axis becomes a loop inside the block).  A step covers T packets of B nnz,
// one thread per nnz (T*B <= 1024):
//   stage 1  each thread decodes its nnz from the fused words (flag bit,
//            int16/int32 column id, f32/bf16/Q15/Q7 value) and multiplies by
//            x[col] (x in shared memory when it fits; out-of-range ids read 0)
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
// Stages 1-3 are one template (walk) shared by the three kernels; the
// stage-4 structs plug into it.
// The next step's words are loaded into registers before the current step's
// scans, hiding part of the load latency.  Known limits, for later work: with
// c = 32 cores only 32 of 132 SMs stream (a core's stream is not yet split
// across blocks), each step costs several block barriers, and the
// multi-query kernel re-reads a core's words once per query chunk.
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
  int fmt;               // 0 F32, 1 BF16, 2 Q15, 3 Q7
  int k;
  int n_rows;            // slot budget: sentinel slot of empty entries
  int x_in_smem;
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
  const int vj = p.fmt == 0 ? j : (p.fmt == 3 ? (j >> 2) : (j >> 1));
  r.val_word = __ldg(row + wf + p.col_words + vj);
  return r;
}

__device__ inline void decode(const Params& p, const Raw& r, int j, int* flag, int* col,
                              float* val) {
  *flag = (r.flag_word >> (j & 31)) & 1;
  if (p.col_words == p.block) {
    *col = r.col_word;
  } else {
    *col = static_cast<int16_t>((static_cast<unsigned>(r.col_word) >> ((j & 1) * 16)) & 0xffffu);
  }
  const unsigned w = static_cast<unsigned>(r.val_word);
  switch (p.fmt) {
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

// Stage 4' of the accumulate kernel: each completed row is stored at its
// slot of the zero-filled (C, n_rows) output.  Completed slot ids never
// repeat, so plain stores suffice.  0.0f + c gives the bits the reference's
// scatter-add onto zeros gives (-0.0 becomes +0.0).
struct AccumStage {
  __device__ void init(const Params&, Smem&, int, int, int) const {}
  __device__ void row_done(const Params& p, Smem&, int core, int, int r, float c,
                           int) const {
    if (r < p.n_rows) p.out_v[static_cast<long long>(core) * p.n_rows + r] = __fadd_rn(0.0f, c);
  }
  __device__ void end_step(const Params&, Smem&, int, int, int) const {}
  __device__ void finish(const Params&, Smem&, int, int, int, int, int) const {}
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
  Raw next = load_raw(p, core, 0, tid);
  for (long long step = 0; step < n_steps; ++step) {
    const Raw cur = next;
    if (step + 1 < n_steps) next = load_raw(p, core, step + 1, tid);
    int f, col;
    float v;
    decode(p, cur, j, &f, &col, &v);
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

__global__ void topk_spmv_mq_kernel(Params p) {
  const int q0 = blockIdx.y * p.q_chunk;
  walk(p, blockIdx.x, q0, min(p.q_chunk, p.nq - q0), TopkStage{});
}

__global__ void spmv_accum_kernel(Params p) { walk(p, blockIdx.x, 0, 1, AccumStage{}); }

enum class Kind { kTopk, kMultiquery, kAccumulate };

int launch(Kind kind, const float* x, const int32_t* words, float* out_v, int32_t* out_r,
           int n_cores, long long n_packets, int width, int m, int nq, int q_chunk,
           int block, int per_step, int col_words, int fmt, int k, int n_rows,
           cudaStream_t stream) {
  const int tb = block * per_step;
  if (tb % 32 != 0 || tb > 1024 || n_cores < 1 || k < 1 || q_chunk < 1 ||
      n_packets % per_step != 0 || n_packets < per_step) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t kSmemLimit = 227 * 1024;
  Params p{x, words, out_v, out_r, n_cores, n_packets, width, m, nq, q_chunk, block,
           per_step, col_words, fmt, k, n_rows, 1};
  size_t bytes = smem_bytes(tb, q_chunk, k, m, 1);
  if (bytes > 160 * 1024) {
    p.x_in_smem = 0;
    bytes = smem_bytes(tb, q_chunk, k, m, 0);
    if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = kind == Kind::kMultiquery
                       ? reinterpret_cast<const void*>(topk_spmv_mq_kernel)
                   : kind == Kind::kTopk ? reinterpret_cast<const void*>(topk_spmv_kernel)
                                         : reinterpret_cast<const void*>(spmv_accum_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kind == Kind::kMultiquery) {
    dim3 grid(n_cores, (nq + q_chunk - 1) / q_chunk);
    topk_spmv_mq_kernel<<<grid, tb, bytes, stream>>>(p);
  } else if (kind == Kind::kTopk) {
    topk_spmv_kernel<<<n_cores, tb, bytes, stream>>>(p);
  } else {
    spmv_accum_kernel<<<n_cores, tb, bytes, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bscsr_topk_spmv_launch(const float* x, const int32_t* words, float* out_v,
                                      int32_t* out_r, int n_cores, long long n_packets,
                                      int width, int m, int nq, int q_chunk, int block,
                                      int per_step, int col_words, int fmt, int k,
                                      int n_rows, void* stream) {
  return launch(Kind::kTopk, x, words, out_v, out_r, n_cores, n_packets, width, m, 1, 1,
                block, per_step, col_words, fmt, k, n_rows,
                static_cast<cudaStream_t>(stream));
}

extern "C" int bscsr_topk_spmv_multiquery_launch(const float* x, const int32_t* words,
                                                 float* out_v, int32_t* out_r, int n_cores,
                                                 long long n_packets, int width, int m,
                                                 int nq, int q_chunk, int block,
                                                 int per_step, int col_words, int fmt,
                                                 int k, int n_rows, void* stream) {
  return launch(Kind::kMultiquery, x, words, out_v, out_r, n_cores, n_packets, width, m,
                nq, q_chunk, block, per_step, col_words, fmt, k, n_rows,
                static_cast<cudaStream_t>(stream));
}

// Accumulate mode: out (C, n_rows) f32, zero-filled by the caller.
extern "C" int bscsr_spmv_launch(const float* x, const int32_t* words, float* out,
                                 int n_cores, long long n_packets, int width, int m,
                                 int block, int per_step, int col_words, int fmt,
                                 int n_rows, void* stream) {
  return launch(Kind::kAccumulate, x, words, out, nullptr, n_cores, n_packets, width, m,
                1, 1, block, per_step, col_words, fmt, 1, n_rows,
                static_cast<cudaStream_t>(stream));
}
