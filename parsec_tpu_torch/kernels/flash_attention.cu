// Flash attention forward for Hopper (sm_90a), CUDA C++ on the tensor cores.
//
// Replaces the Pallas kernel _fa_kernel (parsec_tpu/ops/flash_attention.py:
// 33-80, launched by _flash_fwd at :83-107).  Per lane (batch*head) b:
//   o[b] = softmax(q[b] k[b]^T * scale [+ causal mask]) v[b]
// with the online max / sum / accumulator recurrence in f32, never
// materialising the [Lq, Lk] score matrix.  Kept from the reference: the
// causal kv-block skip (:47), the -1e30 mask sentinel (:62), p zeroed
// where s <= -5e29 under causal masking (:69), and the final
// acc / max(l, 1e-30) (:79-80).
//
// Bound: operations.  Both products run on the tensor cores as TF32
// wgmma (m64nNk8) with f32 accumulation.  One TF32 pass keeps 11 bits of
// each operand and cannot hold the reference's 2e-5 tolerance, but the
// split form can: f32 operands are split, x = big + small with
// big = tf32(x) and small = tf32(x - big) (both rounded as
// cvt.rna.tf32.f32 rounds), and each product is taken as three passes,
// small*big + big*small + big*big (the 3xTF32 scheme).  bf16 and f16
// values are exact in TF32, so their Q.K^T takes one pass and P.V two (P
// is f32).  The three passes bound the f32 work at 3 * 4*Lq*Lk*D per lane
// over the TF32 tensor rate (less the blocks skipped under causal
// masking).  The tensor cores' f32 accumulation drops more low bits than
// an f32 FMA does, so long sums are not left to them: Q.K^T is summed
// there over 64 of D at a time and P.V over one kv tile, and those partial
// sums are added on the CUDA cores (acc = acc * corr + P V, as the
// reference writes it).
//
// Design: one 256-thread block, two warpgroups, per (128-row q block,
// lane); each warpgroup owns 64 query rows (a 64-row tail past Lq leaves
// the second one idle) and keeps its scores S, row max m, row sum l and
// output accumulator in registers, FlashAttention-2's layout.  Q is split
// once into shared memory in wgmma's core-matrix layout; each warp also
// keeps its rows' big part as A fragments in registers, so two of the
// three Q.K^T passes read only K from shared memory.  K and V arrive in
// 32-row tiles by cp.async (16 bytes a copy) into a raw tile while the
// previous tile computes; the block then splits the raw tile once into
// TF32 big and small tiles in the core-matrix layouts (V transposed, as
// TF32 wgmma takes only K-major operands) and runs the products from
// those.  The k index of each k8 step of P.V is taken in the order
// (0,2,4,6,1,3,5,7) of its 8 keys: the S accumulator then already holds
// P as the A fragment of P.V (no relayout through shared memory or
// shuffles).  exp is exp2f with scale*log2(e) folded into the scores.  K
// and V take a lane stride, which is 0 when every lane reads the same K/V
// (one launch for a whole wave; the tiles then come from L2).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;      // query rows per block: two warpgroups of 64
constexpr int NT = 256;      // threads
constexpr int BK = 32;       // key rows per kv tile
constexpr int SKC = 8;       // k steps of Q.K^T summed on the tensor cores
constexpr float kNegBig = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// two neighbouring 16-bit elements as floats
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
// four neighbouring elements as floats
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <typename T> __device__ __forceinline__ float4 ld4(const T* p) {
  const float2 a = ld2(p), b = ld2(p + 2);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, on the 13 low bits), but on the integer pipe: the cvt runs
// on the conversion unit at a fraction of the rate
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (the tensor cores would truncate raw f32 bits)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// wgmma shared-memory operand: no swizzle, K-major core matrices of
// 8 rows x 16 bytes; lbo steps along K, sbo to the next 8 rows
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// wgmma's accumulator operands, 8 at a time
#define PTC_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PTC_WGMMA(n) "wgmma.mma_async.sync.aligned.m64n" #n "k8.f32.tf32.tf32 "
#define PTC_SCALE_D(i) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #i ", 0;\n"

// d (+)= a * b for one warpgroup: m64nNk8, A (TF32) from registers, B
// (TF32) from shared memory, f32 accumulators; scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int scale_d);
template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(PTC_SCALE_D(21) PTC_WGMMA(32)
               "{%0, %1, %2, %3, %4, %5, %6, %7, "
               "%8, %9, %10, %11, %12, %13, %14, %15}, "
               "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : PTC_D8(0), PTC_D8(8)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(PTC_SCALE_D(37) PTC_WGMMA(64)
               "{%0, %1, %2, %3, %4, %5, %6, %7, "
               "%8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, "
               "%24, %25, %26, %27, %28, %29, %30, %31}, "
               "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : PTC_D8(0), PTC_D8(8), PTC_D8(16), PTC_D8(24)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(scale_d));
}

// d (+)= a * b for one warpgroup, m64n32k8 with A (TF32) from shared
// memory as well
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(PTC_SCALE_D(18) PTC_WGMMA(32)
               "{%0, %1, %2, %3, %4, %5, %6, %7, "
               "%8, %9, %10, %11, %12, %13, %14, %15}, "
               "%16, %17, p, 1, 1;\n}\n"
               : PTC_D8(0), PTC_D8(8)
               : "l"(a), "l"(b), "r"(scale_d));
}

// the TF32 parts of 4 neighbouring values: big to b, small (f32 only) to s
template <bool kSplit>
__device__ __forceinline__ void store_split(float* b, float* s, float4 x) {
  if constexpr (kSplit) {
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(b) = hi;
    *reinterpret_cast<uint4*>(s) = lo;
  } else {
    *reinterpret_cast<float4*>(b) = x;
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// shared memory: Q (BQ x D) and the K and V tiles (BK x D each) as TF32
// big parts and, for f32, small parts; then the raw K and V tiles, rows
// padded by 16 bytes so the split pass reads them without bank conflicts
template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (sizeof(T) == 4 ? 2 : 1) * (size_t(BQ) + 2 * BK) * D +
         sizeof(T) * 2 * BK * (D + 16 / sizeof(T));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
                 long long q_ls, long long k_ls, long long v_ls, float scale,
                 int causal) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32, 64 or 128");
  constexpr bool kSplit = sizeof(T) == 4;  // 16-bit values are exact in TF32
  constexpr int RS = D + 16 / sizeof(T);   // raw K/V row stride (elements)
  constexpr int CE = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int CPR = D / CE;              // copies per row
  constexpr int NQ = D / 4;                // quads (4 elements) per row
  constexpr int NS = kSplit ? 2 : 1;       // big and small, or big only
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  // Q, K, V split into TF32 parts in wgmma's core-matrix layouts: [part]
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + NS * BQ * D;
  float* vs = ks + NS * BK * D;
  T* rk = reinterpret_cast<T*>(vs + NS * BK * D);  // the raw K, V tiles
  T* rv = rk + BK * RS;
  const int g = (threadIdx.x & 31) >> 2;  // fragment row group
  const int t = threadIdx.x & 3;          // thread in the group
  const int lane = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int w0 = q0 + warp * 16;  // this warp's first query row
  const int g0 = q0 + (warp >> 2) * 64;  // its warpgroup's first row
  const bool active = g0 < Lq;  // Lq % 64 == 0: all of a warpgroup or none
  const T* kp = k + lane * k_ls;
  const T* vp = v + lane * v_ls;

  // causal: a kv tile whose first key is past the block's last query is
  // fully masked, and so is every later one
  int nkb = Lk / BK;
  if (causal) nkb = min(nkb, (min(Lq, q0 + BQ) - 1) / BK + 1);

  auto stage_in = [&](int kb) {
    const T* gk = kp + static_cast<long long>(kb) * BK * D;
    const T* gv = vp + static_cast<long long>(kb) * BK * D;
    for (int i = threadIdx.x; i < BK * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * CE;
      cp_async16(rk + r * RS + c, gk + r * D + c);
      cp_async16(rv + r * RS + c, gv + r * D + c);
    }
  };
  stage_in(0);
  cp_async_commit();

  // each warp splits its 16 q rows into the A layout of Q.K^T (m = row,
  // k = d; core (row/8, d/4) holds rows 8i..8i+7 x d 4c..4c+3)
  if (active) {
    const T* qw = q + lane * q_ls + static_cast<long long>(w0) * D;
    for (int i = threadIdx.x & 31; i < 16 * NQ; i += 32) {
      const int r = i & 7, cq = (i >> 3) % NQ, h = i / (8 * NQ);
      const float4 x = ld4(qw + (h * 8 + r) * D + cq * 4);
      const int o = (warp * 2 + h) * 8 * D + cq * 32 + r * 4;
      store_split<kSplit>(qs + o, qs + BQ * D + o, x);
    }
  }
  // Q's big part as A fragments in registers: rows g, g+8 at d kk*8 + t,
  // kk*8 + t + 4
  uint32_t qa[D / 8][4];
  __syncwarp();
  {
    const float* qr = qs + warp * 16 * D + g * 4 + t;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      qa[kk][0] = __float_as_uint(qr[kk * 64]);
      qa[kk][1] = __float_as_uint(qr[8 * D + kk * 64]);
      qa[kk][2] = __float_as_uint(qr[kk * 64 + 32]);
      qa[kk][3] = __float_as_uint(qr[8 * D + kk * 64 + 32]);
    }
  }
  float acc[D / 2];  // [nd*4 + .] = rows g, g+8 at columns nd*8 + 2t, +1
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // rows g and g+8: running max (log2 units), this thread's share of the
  // running sum
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * kLog2e;

  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<0>();  // this thread's copies of tile kb
    __syncthreads();     // everyone's; the split tiles of kb-1 are free
    {
      // split tile kb into the core-matrix layouts.  K (B of Q.K^T, n =
      // key, k = d): core (key/8, d/4) holds 8 keys x d 4c..4c+3.  V (B
      // of P.V, n = d, k = key): core (k step key/8, key % 2) holds
      // keys 8j + {0,2,4,6} or {1,3,5,7} of 8 d: the k order
      // (0,2,4,6,1,3,5,7) in which the S accumulator is P's A fragment
      for (int i = threadIdx.x; i < BK * NQ; i += NT) {
        const int r = i & 7, cq = (i >> 3) % NQ, blk = i / (8 * NQ);
        const int row = blk * 8 + r;
        const int ko = blk * 8 * D + cq * 32 + r * 4;
        store_split<kSplit>(ks + ko, ks + BK * D + ko,
                            ld4(rk + row * RS + cq * 4));
      }
      // V: one core row (d, 4 keys of one parity) per step, lanes along d
      for (int i = threadIdx.x; i < BK * D / 4; i += NT) {
        const int d = i % D, jc = i / D;  // jc = key block * 2 + parity
        const T* x = rv + ((jc >> 1) * 8 + (jc & 1)) * RS + d;
        const float4 y = make_float4(to_f(x[0]), to_f(x[2 * RS]),
                                     to_f(x[4 * RS]), to_f(x[6 * RS]));
        const int vo = (d >> 3) * 8 * BK + jc * 32 + (d & 7) * 4;
        store_split<kSplit>(vs + vo, vs + BK * D + vo, y);
      }
    }
    // the split tiles were written by the threads; wgmma reads them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // split tiles ready; the raw tiles are free
    if (kb + 1 < nkb) stage_in(kb + 1);
    cp_async_commit();
    const int k0 = kb * BK;
    // a tile fully masked for this warpgroup leaves m, l, acc unchanged
    if (!active || (causal && k0 > g0 + 63)) continue;

    // S = Q K^T: this warpgroup's 64 rows x BK keys; in this thread
    // [nt*4 + .] = rows g, g+8 of its warp at keys nt*8 + 2t, +1.  Each
    // SKC k steps are summed on the tensor cores into their own
    // accumulator, and those partial sums into s in f32
    constexpr int NCH = (D / 8 + SKC - 1) / SKC;
    float sp[NCH][BK / 2];
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(sp[c]);
    wgmma_fence();
    const float* qg = qs + (warp >> 2) * 64 * D;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float(&d)[BK / 2] = sp[kk / SKC];
      const int first = kk % SKC == 0;
      const uint64_t kbd = smem_desc(ks + kk * 64, 128, 32 * D);
      if constexpr (kSplit) {
        wgmma_ss32(d, smem_desc(qg + BQ * D + kk * 64, 128, 32 * D), kbd,
                   !first);
        wgmma<BK>(d, qa[kk], smem_desc(ks + BK * D + kk * 64, 128, 32 * D),
                  1);
        wgmma<BK>(d, qa[kk], kbd, 1);
      } else {
        wgmma<BK>(d, qa[kk], kbd, !first);
      }
    }
    wgmma_commit();
    wgmma_wait();
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      fence_regs(sp[c]);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] += sp[c][i];
    }

    // online softmax in log2 units; the 4 threads of a row group hold
    // one row's keys
    const bool mask = causal && k0 + BK - 1 > w0;
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int nt = i >> 2, e = i & 3;
      float x = s[i] * sl2;
      if (mask && k0 + nt * 8 + 2 * t + (e & 1) > w0 + g + (e >> 1) * 8)
        x = kNegBig;
      s[i] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int e = i & 3;
      float p = exp2f(s[i] - (e < 2 ? mn0 : mn1));
      // a row fully masked so far contributes nothing even when the max
      // is the sentinel (exp(0) == 1 would poison it otherwise)
      if (causal && s[i] <= kNegBig / 2) p = 0.f;
      s[i] = p;
      if (e < 2) rs0 += p;
      else rs1 += p;
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;

    // acc = acc * corr + P V, P V summed on the tensor cores over this
    // tile only.  The S accumulator of key block j is P's A fragment with
    // k index t <-> key j*8 + 2t and t + 4 <-> key j*8 + 2t + 1
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float pa[4] = {s[j * 4], s[j * 4 + 2], s[j * 4 + 1],
                           s[j * 4 + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(pa[e], pb[j][e], ps[j][e]);
    }
    // in column halves at D = 128, to stay within the register file
    constexpr int DN = D > 64 ? D / 2 : D;
#pragma unroll
    for (int h = 0; h < D / DN; ++h) {
      float pv[DN / 2];
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float* vb = vs + h * DN * BK + j * 64;
        const uint64_t db = smem_desc(vb, 128, 32 * BK);
        wgmma<DN>(pv, ps[j], db, j > 0);
        if constexpr (kSplit)
          wgmma<DN>(pv, pb[j], smem_desc(vb + BK * D, 128, 32 * BK), 1);
        wgmma<DN>(pv, pb[j], db, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i)
        acc[h * DN / 2 + i] =
            fmaf(acc[h * DN / 2 + i], (i & 3) < 2 ? c0 : c1, pv[i]);
    }
  }
  cp_async_wait<0>();

  if (active) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    T* r0 = o + static_cast<long long>(lane) * Lq * D +
            static_cast<long long>(w0 + g) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      st2(r0 + nd * 8, acc[nd * 4] / den0, acc[nd * 4 + 1] / den0);
      st2(r0 + 8 * D + nd * 8, acc[nd * 4 + 2] / den1,
          acc[nd * 4 + 3] / den1);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int lanes,
           int Lq, int Lk, long long q_ls, long long k_ls, long long v_ls,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, lanes);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, q_ls, k_ls, v_ls,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int lanes,
             int Lq, int Lk, int D, long long q_ls, long long k_ls,
             long long v_ls, float scale, int causal, cudaStream_t s) {
  // cp.async copies 16 bytes: every lane's rows must start 16-byte aligned
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o);
  if (ptrs % 16 || (q_ls * sizeof(T)) % 16 || (k_ls * sizeof(T)) % 16 ||
      (v_ls * sizeof(T)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lanes, Lq, Lk, q_ls, k_ls, v_ls, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lanes, Lq, Lk, q_ls, k_ls, v_ls, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lanes, Lq, Lk, q_ls, k_ls, v_ls, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int occupancy(int* smem, int* blocks) {
  constexpr size_t bytes = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(bytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_fwd_kernel<T, D>, NT, bytes));
}

template <typename T>
int occupancy_d(int D, int* smem, int* blocks) {
  switch (D) {
    case 32: return occupancy<T, 32>(smem, blocks);
    case 64: return occupancy<T, 64>(smem, blocks);
    case 128: return occupancy<T, 128>(smem, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The launch's shape for one instantiation: dynamic shared memory bytes a
// block, threads a block, and blocks resident on one SM (the runtime's
// occupancy calculator).
extern "C" int ptc_flash_attention_occupancy(int D, int dtype, int* smem,
                                             int* threads, int* blocks) {
  *threads = NT;
  switch (dtype) {
    case 0: return occupancy_d<float>(D, smem, blocks);
    case 1: return occupancy_d<__nv_bfloat16>(D, smem, blocks);
    case 2: return occupancy_d<__half>(D, smem, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q [lanes, Lq, D] (lane stride q_ls), k/v [lanes, Lk, D] (lane strides
// k_ls/v_ls, 0 allowed), rows contiguous; o [lanes, Lq, D] contiguous.
// Lq and Lk multiples of 64; D in {32, 64, 128}; pointers and lane
// strides 16-byte aligned.
// dtype codes: 0 float32, 1 bfloat16, 2 float16.
extern "C" int ptc_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int lanes, int Lq,
                                   int Lk, int D, long long q_ls,
                                   long long k_ls, long long v_ls,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || lanes > 65535 || Lq % 64 || Lk % BK || Lq <= 0 || Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, lanes, Lq, Lk, D, q_ls, k_ls, v_ls, scale, causal, s);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, lanes, Lq, Lk, D, q_ls, k_ls, v_ls, scale, causal, s);
    case 2: return launch_d<__half>(q, k, v, o, lanes, Lq, Lk, D, q_ls, k_ls, v_ls, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ptc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
