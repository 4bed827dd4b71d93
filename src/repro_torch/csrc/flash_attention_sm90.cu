// Forward flash attention for Hopper (sm_90a) on the tensor cores: bf16
// q/k/v at head dims 64, 128 and 256, f32 accumulation. Plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _attn_kernel), with the same function as
// csrc/flash_attention.cu, which stays for f32 and for bf16 at d 16 and
// 32: tiled online softmax with running max m, denominator l and
// accumulator acc in f32; scale 1/sqrt(d); GQA maps query head h to kv
// head h / (H / Hkv) without repeating K/V; masks k < Sk, causal k <= q,
// window (q - k) < window, with query and key positions both starting at
// 0; output acc / max(l, 1e-30) in q's dtype, so a row with no attendable
// key is 0.
//
// Bound at the serving slice's shape (B 8, H 64, Hkv 8, S 2048, d 128,
// causal): 4 * B * H * d * S * (S + 1) / 2 = 5.50e11 operations against
// about 0.27 GB moved, so it is bound by operations: 0.556 ms at the
// H100's 989 TFLOP/s dense bf16 tensor-core rate.
//
// Design, point by point against the f32 SIMT kernel:
// 1. Tensor cores. S = Q K^T is wgmma.mma_async m64nBKk16 with both
//    operands in shared memory (K-major, 128-byte swizzle), d / 16 steps.
//    O += P V is m64nDk16 with P as the register A operand: the S
//    accumulator is rounded to bf16 in place, since its fragment is the A
//    fragment, so P never touches shared memory. V is read as the
//    MN-major (transposed) B operand, which 16-bit types allow, so it is
//    used as TMA stored it.
// 2. Loads. One thread of a producer warpgroup issues TMA copies of whole
//    tiles (4-D tensor maps over the callers' tensors through their
//    strides, so nothing is copied; rows past S come back as zeros and are
//    masked by position). Q stays resident for an item; K and V each go
//    through a ring of STAGES stages guarded by full/empty mbarriers, so
//    the next tiles' copies run under this tile's products. setmaxnreg
//    moves registers from the producer (24) to the two consumer
//    warpgroups (240), each of which owns 64 of the block's 128 query
//    rows, with m and l in registers per row of its accumulator fragment.
// 3. No block-wide barrier and no shared-memory round trip in the loop:
//    P stays in registers (above), and the consumers synchronise with the
//    producer through the mbarriers alone. Each consumer pipelines its own
//    loop (S of tile t is issued with P V of tile t - 1, and the softmax
//    of tile t runs while the latter does), and the two consumers take
//    turns on the tensor cores (named barriers), so one's softmax runs
//    under the other's products.
// 4. Softmax. log2(e) is folded into the scale and the exponentials are
//    exp2f. Only tiles that cross the causal diagonal, the window's start
//    or the Sk edge are masked. The loop runs from the window's first
//    tile to the diagonal.
// Scheduling: persistent, one block an SM. Work items (one (b, h) and one
// 128-row query tile) are dealt out longest first under a causal mask, in
// rounds that alternate direction, and each block's next item is loaded
// while its last one finishes (the rings run on across items).
// Tiles: BQ 128; BK 128 at d <= 128, 64 at d 256, where Q (64 KB) and two
// stages of K and V (128 KB) fill 192 KB of shared memory. The output is
// written from registers, rows past Sq skipped. The kernel allocates
// nothing: the tensor maps are kernel parameters, encoded on the host at
// every call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 128;       // query rows a block
constexpr int NCONSUMER = 2;  // consumer warpgroups, 64 rows each
constexpr int NT = 128 * (NCONSUMER + 1);
constexpr int STAGES = 2;     // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int NBOX = D / 64;            // 128-byte boxes across d
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // K or V, one stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // + barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

struct Args {
  void* o;
  int B, H, Hkv, Sq, Sk;
  long long ob, oh, os;  // element strides of the output
  int causal;
  int window;            // <= 0: no window
  float scale_log2;      // log2(e) / sqrt(d)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete. (No trap on a long
// wait: a trap path makes ptxas drop the setmaxnreg register budget and
// spill the consumers.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major: sbo is the
// stride between 8-row groups (lbo unused). MN-major: lbo is the stride
// between 64-element blocks of the contiguous dimension, sbo between
// groups of 8 along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void mma_qk(float (&s)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma::wgmma_ss_m64n64k16(s, da, db, scale_d);
  else wgmma::wgmma_ss_m64n128k16(s, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_pv(float (&o)[N / 2],
                                       const uint32_t (&p)[4], uint64_t db) {
  if constexpr (N == 64) wgmma::wgmma_rs_m64n64k16_tb(o, p, db);
  else if constexpr (N == 128) wgmma::wgmma_rs_m64n128k16_tb(o, p, db);
  else wgmma::wgmma_rs_m64n256k16_tb(o, p, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The barriers of a block: Q, then a full and an empty barrier for each
// stage of the K ring and of the V ring.
struct Bars {
  uint32_t q, q_empty, full_k, full_v, empty_k, empty_v;  // full_k + 8 s ...
  __device__ Bars(uint32_t base)
      : q(base),
        q_empty(base + 8),
        full_k(base + 16),
        full_v(base + 16 + 8 * STAGES),
        empty_k(base + 16 + 16 * STAGES),
        empty_v(base + 16 + 24 * STAGES) {}
};

// A work item: one (b, h) and one tile of BQ query rows, with the kv tiles
// it sees. Items are numbered longest first under a causal mask, (b, h)
// fastest. Round r of the persistent grid's G blocks takes items
// r G .. r G + G - 1, block j item r G + j in even rounds and
// r G + G - 1 - j in odd ones, so that no block takes the longest item of
// every round.
__device__ __forceinline__ int item_of(int round) {
  return round * gridDim.x +
         ((round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

template <int BK>
struct Item {
  int b, h, hk, q0, k_begin, n_tiles;
  __device__ Item(const Args& a, int i, int n_q_tiles) {
    const int bh = i % (a.B * a.H);
    b = bh / a.H;
    h = bh % a.H;
    hk = h / (a.H / a.Hkv);
    q0 = (n_q_tiles - 1 - i / (a.B * a.H)) * BQ;
    int k_end = a.Sk;
    if (a.causal) k_end = min(k_end, q0 + BQ);
    k_begin = 0;
    if (a.window > 0) k_begin = max(0, q0 - a.window + 1) / BK * BK;
    n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  }
};

// tile t of the ring: its stage and the parity of that stage's phase
__device__ __forceinline__ uint32_t slot(int t) { return t % STAGES; }
__device__ __forceinline__ uint32_t parity(int t) { return (t / STAGES) & 1; }

template <int D>
__device__ __forceinline__ void qk(float (&s)[Cfg<D>::BK / 2], uint32_t qa,
                                   uint32_t kb) {
  constexpr int BK = Cfg<D>::BK;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;   // 16 bf16 a step
    mma_qk<BK>(s, desc_sw128(qa + (kk / 4) * BQ * 128 + in_box, 16, 1024),
               desc_sw128(kb + (kk / 4) * BK * 128 + in_box, 16, 1024),
               kk > 0);
  }
}

// O += P V, V read MN-major: 16 keys a step, 2048 bytes apart
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&p)[Cfg<D>::BK / 16][4],
                                   uint32_t vb) {
  constexpr int BK = Cfg<D>::BK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_pv<D>(o, p[kk], desc_sw128(vb + kk * 16 * 128, BK * 128, 1024));
}

// Masks the S tile at keys k0.. where it crosses an edge of what rows
// [q_lo, q_lo + 64) see, then takes the online-softmax step in base 2:
// s becomes p, m and l move on, corr is the factor for O. Each row is
// spread over 4 lanes.
template <int BK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        const Args& a, int k0, int q_lo,
                                        int row0, int lane) {
  const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > q_lo) ||
                    (a.window > 0 && q_lo + 63 - k0 >= a.window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qp = row0 + 8 * ((i / 2) % 2);
      const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      bool ok = kp < a.Sk;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && (qp - kp) < a.window;
      if (!ok) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if ((i / 2) % 2 == r) mx = fmaxf(mx, s[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * a.scale_log2);
    // a row with nothing attendable yet keeps p = 0 and corr = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = exp2f(m[r] - m_use);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 2) % 2 == r) {
        s[i] = exp2f(fmaf(s[i], a.scale_log2, -m_use));
        sum += s[i];
      }
    }
    l[r] = l[r] * corr[r] + sum;
  }
}

// P as the bf16 A fragment: registers 8 kk .. 8 kk + 7 of S hold keys
// 16 kk .. 16 kk + 15 of this thread's two rows
template <int BK>
__device__ __forceinline__ void to_bf16(uint32_t (&p)[BK / 16][4],
                                        const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// Ping-pong between the two consumer warpgroups: each issues its products
// only in its turn (named barrier 1 + c), then hands the turn over, so
// that one's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(256) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(256) : "memory");
}

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// One consumer warpgroup c: rows 64 c .. 64 c + 63 of each of its block's
// items. The kv loop is software-pipelined: S of tile t runs on the
// tensor cores together with P V of tile t - 1, and the softmax of tile t
// overlaps the latter. The K/V ring runs on across items (t_all counts
// its tiles), and Q is handed back as soon as an item's last S is done,
// so the next item's loads run under this item's last P V and its output.
template <int D>
__device__ __forceinline__ void consume(const Args& a, const Bars& bar,
                                        int c, int n_q_tiles, uint32_t sQ,
                                        uint32_t sK, uint32_t sV) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t qa = sQ + c * 64 * 128;   // this warpgroup's rows of Q
  const int n_items = n_q_tiles * a.B * a.H;

  float o[D / 2];
  float m[2], l[2], corr[2];
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  int t_all = 0;
  if (c == 1) turn_pass(c);   // consumer 0 goes first

  for (int n_done = 0; item_of(n_done) < n_items; ++n_done) {
    const Item<BK> it(a, item_of(n_done), n_q_tiles);
    const int q_lo = it.q0 + 64 * c;
    const int row0 = q_lo + 16 * warp + lane / 4;   // and row0 + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    mbar_wait(bar.q, n_done & 1);
    if (it.n_tiles > 0) {
      mbar_wait(bar.full_k + 8 * slot(t_all), parity(t_all));
      wgmma::fence_regs(s);
      turn_wait(c);
      wgmma::fence();
      qk<D>(s, qa, sK + slot(t_all) * C::KV_BYTES);
      wgmma::commit();
      turn_pass(c);
      wgmma::wait<0>();
      wgmma::fence_regs(s);
      release(bar.empty_k + 8 * slot(t_all), lane);
      softmax<BK>(s, m, l, corr, a, it.k_begin, q_lo, row0, lane);
      to_bf16<BK>(p, s);
    }
    for (int t = 1; t < it.n_tiles; ++t) {
      const int kt = t_all + t, vt = kt - 1;   // vt: the tile whose P V runs
      mbar_wait(bar.full_k + 8 * slot(kt), parity(kt));
      mbar_wait(bar.full_v + 8 * slot(vt), parity(vt));
      wgmma::fence_regs(s);
      wgmma::fence_regs(o);
      turn_wait(c);
      wgmma::fence();
      qk<D>(s, qa, sK + slot(kt) * C::KV_BYTES);
      wgmma::commit();
      pv<D>(o, p, sV + slot(vt) * C::KV_BYTES);
      wgmma::commit();
      turn_pass(c);
      wgmma::wait<1>();      // S done, P V may still run
      wgmma::fence_regs(s);
      release(bar.empty_k + 8 * slot(kt), lane);
      softmax<BK>(s, m, l, corr, a, it.k_begin + t * BK, q_lo, row0, lane);
      wgmma::wait<0>();
      wgmma::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma::fence_regs(p[kk]);
      release(bar.empty_v + 8 * slot(vt), lane);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
      to_bf16<BK>(p, s);
    }
    release(bar.q_empty, lane);   // every S of this item is done
    if (it.n_tiles > 0) {
      const int vt = t_all + it.n_tiles - 1;
      mbar_wait(bar.full_v + 8 * slot(vt), parity(vt));
      wgmma::fence_regs(o);
      turn_wait(c);
      wgmma::fence();
      pv<D>(o, p, sV + slot(vt) * C::KV_BYTES);
      wgmma::commit();
      turn_pass(c);
      wgmma::wait<0>();
      wgmma::fence_regs(o);
      release(bar.empty_v + 8 * slot(vt), lane);
    }
    t_all += it.n_tiles;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* out =
        static_cast<__nv_bfloat16*>(a.o) + it.b * a.ob + it.h * a.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row0 + 8 * r;
      if (qr < a.Sq) {
        __nv_bfloat16* orow = out + qr * a.os + 2 * (lane % 4);
#pragma unroll
        for (int cb = 0; cb < D / 8; ++cb) {
          const int j = 4 * cb + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * cb) =
              __floats2bfloat162_rn(o[j] * inv[r], o[j + 1] * inv[r]);
        }
      }
    }
  }
}

// Persistent: one block an SM, each walking its share of the items.
template <int D>
__global__ void __launch_bounds__(NT, 1)
    attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, Args a) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::K_OFF, sV = base + C::V_OFF;
  const Bars bar(base + C::BAR_OFF);
  const int n_q_tiles = (a.Sq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar.q, 1);
    mbar_init(bar.q_empty, 4 * NCONSUMER);   // one arrival a consumer warp
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar.full_k + 8 * s, 1);
      mbar_init(bar.full_v + 8 * s, 1);
      mbar_init(bar.empty_k + 8 * s, 4 * NCONSUMER);
      mbar_init(bar.empty_v + 8 * s, 4 * NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as far as the compiler can see, as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer warpgroup: one thread issues every copy, in the order the
    // consumers need them: Q of an item, then K of tile t before V of t
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int n_items = n_q_tiles * a.B * a.H;
      int t_all = 0;
      for (int n_done = 0; item_of(n_done) < n_items; ++n_done) {
        const Item<BK> it(a, item_of(n_done), n_q_tiles);
        mbar_wait(bar.q_empty, (n_done & 1) ^ 1);
        mbar_expect_tx(bar.q, C::Q_BYTES);
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j)
          tma_load_4d(sQ + j * BQ * 128, &tq, bar.q, 64 * j, it.q0, it.h,
                      it.b);
        for (int t = 0; t < it.n_tiles; ++t, ++t_all) {
          const int k0 = it.k_begin + t * BK;
          const uint32_t off = slot(t_all) * C::KV_BYTES;
          const uint32_t fk = bar.full_k + 8 * slot(t_all);
          const uint32_t fv = bar.full_v + 8 * slot(t_all);
          mbar_wait(bar.empty_k + 8 * slot(t_all), parity(t_all) ^ 1);
          mbar_expect_tx(fk, C::KV_BYTES);
#pragma unroll
          for (int j = 0; j < C::NBOX; ++j)
            tma_load_4d(sK + off + j * BK * 128, &tk, fk, 64 * j, k0, it.hk,
                        it.b);
          mbar_wait(bar.empty_v + 8 * slot(t_all), parity(t_all) ^ 1);
          mbar_expect_tx(fv, C::KV_BYTES);
#pragma unroll
          for (int j = 0; j < C::NBOX; ++j)
            tma_load_4d(sV + off + j * BK * 128, &tv, fv, 64 * j, k0, it.hk,
                        it.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D>(a, bar, wg - 1, n_q_tiles, sQ, sK, sV);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map (d, S, heads, B) over a bf16 tensor addressed by element
// strides; boxes of 64 x rows x 1 x 1 with the 128-byte swizzle. A dim of
// size 1 gets a placeholder stride (TMA wants multiples of 16 bytes).
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D,
                int S, int heads, int B, long long sb, long long sh,
                long long ss, int rows) {
  const long long filler = 2LL * D;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(S == 1 ? filler : 2 * ss),
      static_cast<cuuint64_t>(heads == 1 ? filler : 2 * sh),
      static_cast<cuuint64_t>(B == 1 ? filler : 2 * sb)};
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ENCODE_ERROR = 1000;   // + the CUresult of the encoding

template <int D>
int launch(const void* q, const void* k, const void* v, const Args& a,
           int B, long long qb, long long qh, long long qs, long long kb,
           long long kh, long long ks, long long vb, long long vh,
           long long vs, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  CUresult r = encode(fn, &tq, q, D, a.Sq, a.H, B, qb, qh, qs, BQ);
  if (r == CUDA_SUCCESS)
    r = encode(fn, &tk, k, D, a.Sk, a.Hkv, B, kb, kh, ks, C::BK);
  if (r == CUDA_SUCCESS)
    r = encode(fn, &tv, v, D, a.Sk, a.Hkv, B, vb, vh, vs, C::BK);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_items = 1LL * B * a.H * ((a.Sq + BQ - 1) / BQ);
  const int grid = static_cast<int>(n_items < n_sm ? n_items : n_sm);
  attn_fwd_sm90_kernel<D><<<grid, NT, C::SMEM, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only. Returns 0 when launched, else a cudaError_t, or 1000 + the
// CUresult of a tensor-map encoding that failed.
extern "C" int repro_flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, long long ob, long long oh, long long os, int causal,
    int window, float scale, void* stream) {
  const Args a{o,  B,  H,      Hkv,    Sq,          Sk,
               ob, oh, os, causal, window, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, a, B, qb, qh, qs, kb, kh, ks, vb, vh, vs, st);
    case 128:
      return launch<128>(q, k, v, a, B, qb, qh, qs, kb, kh, ks, vb, vh, vs,
                         st);
    case 256:
      return launch<256>(q, k, v, a, B, qb, qh, qs, kb, kh, ks, vb, vh, vs,
                         st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
