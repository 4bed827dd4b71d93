// Forward flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _attn_kernel). Same function: tiled online
// softmax with running max m, denominator l and accumulator acc in f32;
// scale 1/sqrt(d); GQA maps query head h to kv head h / (H / Hkv) without
// repeating K/V; masks k < Sk, causal k <= q, window (q - k) < window, with
// query and key positions both starting at 0; output acc / max(l, 1e-30),
// so a row with no attendable key is 0.
//
// Design (not a block-by-block copy of the TPU kernel):
// * one thread block per (b*h, 64-row query tile); the TPU's sequential kv
//   grid axis becomes a loop inside the block, so m/l/acc live in
//   registers for the whole row tile;
// * the loop runs only over the kv tiles a tile can see: up to the causal
//   diagonal, and from the start of the window. The ragged edge (S not a
//   multiple of 64) is masked here, so the wrapper neither pads nor copies;
// * Q, K, V tiles and the P tile are staged in shared memory as f32
//   (113 KB at d=128, so dynamic shared memory above the 48 KB default);
// * 256 threads; each thread owns a 4x4 block of the 64x64 score tile and
//   4 rows x d/16 columns of the output, rows and columns strided by 16 so
//   that shared-memory reads are conflict-free or broadcast. Row max and
//   row sum are reduced over the 16 lanes that share a row with shuffles;
// * q, k, v and o are addressed through their strides, so the model's
//   [B, S, H, d] tensors are read and written in place.
//
// Bound at the serving slice's shape (B 8, H 64, Hkv 8, S 2048, d 128, bf16,
// causal): 4*B*H*d*S*(S+1)/2 = 0.55 TFLOP against about 0.6 GB moved, so it
// is bound by operations: about 0.56 ms at the H100's 989 TFLOP/s dense
// bf16 tensor-core rate. What this simple design leaves on the table: it
// does the products as f32 FMAs on the CUDA cores (67 TFLOP/s peak, and
// shared-memory reads hold it to about half of that), with no tensor cores
// (mma.sync / wgmma), no asynchronous copies (cp.async / TMA) overlapping
// the next tile's load with this tile's math, and no warp specialisation.
// Those are the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per kv tile
constexpr int NT = 256;   // threads per block (16 x 16)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, Sq, Sk;
  long long qb, qh, qs;   // element strides of batch, head, position
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  int causal;
  int window;             // <= 0: no window
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         static_cast<size_t>(BQ * (D + 1) + BK * (D + 1) + BK * D +
                             BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK + 1]

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  // the last query tiles see the most keys under a causal mask: start them
  // first so the short tiles fill in behind them
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* q = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* k = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* v = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;
  T* o = static_cast<T*>(a.o) + b * a.ob + h * a.oh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, qr = q0 + r;
    Qs[r * (D + 1) + c] = qr < a.Sq ? load_f(q + qr * a.qs + c) : 0.f;
  }

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) acc[i][dd] = 0.f;
  }

  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's K/V/P are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, kr = k0 + r;
      const bool in = kr < a.Sk;
      Ks[r * (D + 1) + c] = in ? load_f(k + kr * a.ks + c) : 0.f;
      Vs[r * D + c] = in ? load_f(v + kr * a.vs + c) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax, P to shared memory, rescale acc
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool good = kp < a.Sk;
        if (a.causal) good = good && kp <= qp;
        if (a.window > 0) good = good && (qp - kp) < a.window;
        ok[j] = good;
        s[i][j] = good ? s[i][j] * a.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns tx + 16 dd
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const float vv = Vs[kk * D + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dd] = fmaf(p[i], vv, acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr < a.Sq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd)
        store_f(o + qr * a.os + tx + 16 * dd, acc[i][dd] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.H);
  attn_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Hkv, int Sq, int Sk, int D, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int causal, int window, float scale, void* stream) {
  const Args a{q,  k,  v,  o,  H,  Hkv, Sq, Sk, qb,     qh,     qs,   kb,
               kh, ks, vb, vh, vs, ob,  oh, os, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_d<float>(a, B, D, st));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(a, B, D, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
