// K1: clamped-softmax flash-attention forward, bf16/f16, for sm_90a.
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel` (:78, via
// `_flash_attention_fwd_impl`) and `_flash_kernel_stream_fwd` (:456, via
// `_flash_stream_fwd_impl`):
//   O = (exp(clip(Q K^T * D^-1/2, -60, 60)) V) / l,   l = row sum of the f32 exponentials,
// with p cast to the input type before the PV product and O normalised after it.
//
// What bounds it on the H100: per head 4*N^2*D tensor-core FLOPs (989 TFLOP/s)
// and N^2 exponentials (16 a clock an SM), against only 4*N*D*2 bytes of
// Q/K/V/O traffic: compute-bound at every shape of the UNet (N = 1024/4096),
// on the tensor cores at D >= 64 (at D = 64 the exponentials cost as much)
// and on the exponentials and the clamp/convert instructions around them at
// D = 16/32.
// What the design does about it (flash_wgmma.cuh has the building blocks,
// flash_fwd_loop.cuh the schedule, which K2 and K4 share):
//   * Both products run on wgmma. S = Q K^T takes Q and the K tile from
//     shared memory (K-major); O += P V takes P from the registers S left it
//     in and the V tile as loaded (MN-major descriptor): nothing is staged
//     transposed and nothing of size N^2 leaves registers.
//   * K and V tiles of 64 keys come through a three-deep ring filled by
//     16-byte cp.async into the tensor cores' swizzled layout, two tiles
//     ahead of the MMAs; one __syncthreads a tile hands a slot back.
//   * Per score: one f32 multiply by scale * log2 e, the clamp at
//     +-60 * log2 e, ex2.approx. No running max, so O and l add up unscaled
//     across tiles; the 4-lane shuffle for l happens once, at the end.
//   * The exponentials of tile j+1 overlap the P V product of tile j (see
//     the schedule in flash_fwd_loop.cuh); O leaves through shared memory
//     with 16-byte stores.
//   * One warpgroup (64 query rows) a block: two warpgroups sharing a ring
//     measured no faster at any head dim and slower at D = 128 and in K3,
//     and three or four independent blocks an SM hide each other's waits.
// Departures from a textbook Hopper kernel, and why: the loads are cp.async
// by the MMA warps, not TMA by a producer warp (a tensor map holds the
// tensor's address, so it would be encoded on the host at every call of an
// already host-bound path); and S_{j+1} is not kept in flight across
// iterations (ptxas then serializes every wgmma, see flash_fwd_loop.cuh).
// D = 192 (the 256 px UNet's 768-channel layers) is the same kernel on tiles
// of three 64-column panels: 96 O accumulators a thread and 169 KB of shared
// memory, so one block an SM; right first, its time is written down.
// D = 24 (the legacy UNet's attn_up2, 96 channels over 4 heads) runs the
// D = 32 schedule on rows of 24 (G below): each Q, K and V row is staged
// with its last 16 of 64 bytes zero-filled by cp.async (src-size 0, chosen by
// a select; two forms with branches around the copies had their wgmma
// serialized, see cp_async16_zfill). So Q K^T's extra terms are exactly 0,
// P V runs at n = 32 and O's columns 24-31, which are 0, are not stored. The
// scale stays 24^-1/2. Padding the tensors to 32 in the wrapper would add
// three copies and a slice to every call. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md section 6): 0.028 ms at (8, 4, 1024, 24), 1.3x
// D = 32's time on three quarters of its data.
// Left for later: 128-key tiles at D = 16/32 (half the per-tile overhead),
// Q as a register operand (K4, probe_exp2_attn.cu, measures it together with
// a scale folded into q: a gain at D = 64, a loss at D = 128), and strided
// inputs (the wrapper makes them contiguous).
#include "flash_fwd_loop.cuh"

namespace wcflash {

// How K1 makes a score tile and turns it into p (flash_fwd_loop.cuh has the
// schedule): Q from its own swizzled tile in shared memory, one multiply by
// scale * log2 e, the two-sided clamp, ex2.approx.ftz.
template <typename T, int D, int G = D>
struct FwdPolicy {
  using Score = float;
  static constexpr int kQBytes = Tile<D>::kBytes;
  static constexpr int kKTileBytes = Tile<D>::kBytes;

  const T* q_rows;  // the block's 64 rows of Q
  const T* k_head;
  float scale_log2;  // D^-1/2 * log2 e

  __device__ __forceinline__ void prologue(uint32_t q_s, uint32_t, int tid) const {
    load_tile_async<T, D, G>(q_s, q_rows, tid);
  }
  __device__ __forceinline__ void load_k(uint32_t dst, int tile, int tid) const {
    load_tile_async<T, D, G>(dst, k_head + (size_t)tile * kTileRows * G, tid);
  }
  __device__ __forceinline__ void start(float (&s)[kTileRows / 2], uint32_t q_s, uint32_t k_tile) const {
    mma_rows_rows_t<T, D>(s, q_s, k_tile, 0);
  }
  // One score tile (this warp's 16 rows x 64 keys, 32 accumulators a thread):
  // p = exp2(clip(s * scale * log2 e)), its f32 row sums into l, and p packed
  // in pairs as the A fragments of the P V product.
  __device__ __forceinline__ void exp_pack(const float (&s)[kTileRows / 2], float l[2],
                                           uint32_t (&p)[kTileRows / 4]) const {
#pragma unroll
    for (int i = 0; i < kTileRows / 4; ++i) {  // pair i: row g + 8 * (i & 1)
      const float x0 = ex2_ftz(fminf(fmaxf(s[2 * i] * scale_log2, -kClampLog2), kClampLog2));
      const float x1 = ex2_ftz(fminf(fmaxf(s[2 * i + 1] * scale_log2, -kClampLog2), kClampLog2));
      l[i & 1] += x0 + x1;
      p[i] = Mma<T>::pack(x0, x1);
    }
  }
};

// D: the tile's width; G: the tensors' head dim (row stride), D unless G = 24.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWgThreads)
    flash_fwd_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           T* __restrict__ o, float* __restrict__ l_out, int n, float scale_log2) {
  const size_t head = (size_t)blockIdx.y * n * G;
  const size_t row0 = (size_t)blockIdx.x * kTileRows;
  FwdPolicy<T, D, G> policy{q + head + row0 * G, k + head, scale_log2};
  flash_forward_loop<T, D, FwdPolicy<T, D, G>, G>(policy, v + head, o + head + row0 * G,
                                                  l_out == nullptr ? nullptr : l_out + (size_t)blockIdx.y * n + row0, n);
}

template <typename T, int D, int G = D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* l, int bh, int n,
                   float scale, cudaStream_t stream) {
  constexpr int smem = fwd_loop_smem_bytes<T, D, FwdPolicy<T, D, G>>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kTileRows, bh);
  flash_fwd_wgmma_kernel<T, D, G><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), l, n,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* l, int bh, int n,
                       int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, l, bh, n, scale, stream);
    case 24: return launch<T, 32, 24>(q, k, v, o, l, bh, n, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, l, bh, n, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, l, bh, n, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, l, bh, n, scale, stream);
    case 192: return launch<T, 192>(q, k, v, o, l, bh, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wcflash

// q, k, v, o: contiguous (bh, n, d) in bf16 (is_f16 = 0) or f16 (is_f16 = 1).
// l: f32 (bh, n) or null. Returns the cudaError_t of the launch.
extern "C" int wc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* l, int bh,
                            int n, int d, int is_f16, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kBlockQ != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcflash::dispatch_d<__half>(q, k, v, o, l, bh, n, d, scale, s)
                : wcflash::dispatch_d<__nv_bfloat16>(q, k, v, o, l, bh, n, d, scale, s);
}

extern "C" const char* wc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
