// The plane->wire interleave on Hopper (sm_90a).
//
// Replaces the TPU kernel `interleave_kernel` (tools/pallas_probe.py:54,
// pallas_call at :86) and, with it, the XLA twin `Planes.interleave`
// (partisan_tpu/ops/plane.py:167): W word planes, each M records of a
// narrow storage dtype (int8, int16 or int32), become one int32[M, W]
// wire tensor with every word sign-extended.
//
// Bound: bytes.  There is no arithmetic beyond the sign extension, so the
// least time is (bytes read + bytes written) / 3.35 TB/s.  At the main
// path's capture shape (32768 nodes x 77 emission slots, 3 int8 + 1 int16
// + 12 int32 planes) that is 53 B in and 64 B out per record, 295 MB and
// 0.088 ms in all.
//
// What holds a copy like this back is latency: a block that loads a word
// per plane per thread and must see it land before it can write waits W
// round trips to device memory per tile, and at 3.35 TB/s each SM needs
// about 20 KB in flight to cover that.  The design keeps whole tiles in
// flight instead:
// - A persistent grid (as many blocks as fit on the SMs) walks tiles of
//   kTile records.  One thread issues, per tile and plane, one 1-D bulk
//   async copy (cp.async.bulk, no tensor map: each plane's tile is one
//   contiguous run of kTile * elem_bytes bytes) into a stage of a
//   kStages-deep ring in shared memory; the copies complete on the
//   stage's mbarrier.  While the block transposes one stage, the next
//   kStages - 1 tiles are loading: 2 x 27 KB per block on the bench
//   planes, two blocks per SM.
// - The stage is plane-major and narrow planes stay narrow.  Each plane's
//   run starts on a 128-byte line plus a 16-byte-multiple stagger chosen
//   so that the 32 lanes of a warp, which read 4 planes at 8 records (for
//   W = 16), hit 32 different banks.
// - Each thread assembles 16-byte chunks of the output (4 words of one
//   record) from shared memory, sign-extending with shifts (no branch on
//   the element size), and consecutive threads store consecutive chunks:
//   the tile's output, one contiguous run of kTile * W * 4 bytes, is
//   written fully coalesced.
// - Edge cases stay in this kernel: a plane whose base is not 16-byte
//   aligned (a view) and every plane of the ragged last tile are loaded
//   element by element into the same stage; when W is not a multiple of
//   4 or the output is not 16-byte aligned the store is one word a
//   thread, still coalesced.
//
// Interface: plain C, loaded with ctypes.  The launch takes the W plane
// pointers as a host array and the element sizes as a size code (2 bits
// per plane, log2 of the size), and returns cudaGetLastError() so the
// caller raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 32;
constexpr int kTile = 512;     // a multiple of 128: every plane's run in a
                               // stage is a whole number of 128-byte lines
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMaxDevices = 64;

struct Params {
  const unsigned char* ptr[kMaxW];
  int off[kMaxW];            // byte offset of plane w in a stage
  unsigned long long code;   // 2 bits per plane: log2 of its element size
  unsigned bulk;             // bit w: plane w is 16-byte aligned
  unsigned tx_bytes;         // bytes a full tile's bulk copies bring
  int W;
  int stage_bytes;
  int vec_store;             // W % 4 == 0 and out 16-byte aligned
  long long M;
  long long tiles;
  int32_t* out;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Word r of a staged plane, sign-extended.  `t` is the plane's entry of
// the block's table: its stage offset << 2 | log2 of its element size.
__device__ __forceinline__ int32_t staged_word(const unsigned char* stage,
                                               int t, int r) {
  const int lg = t & 3;
  const uint32_t a = static_cast<uint32_t>(t >> 2) +
                     (static_cast<uint32_t>(r) << lg);
  const uint32_t v =
      *reinterpret_cast<const uint32_t*>(stage + (a & ~3u));
  const int bits = 8 << lg;
  return static_cast<int32_t>(v << (32 - bits - 8 * (a & 3u))) >>
         (32 - bits);
}

// One thread fills stage `s` with the bulk-copied planes of tile `t` (none
// for the ragged last tile, whose planes are all loaded element-wise).
__device__ __forceinline__ void issue_tile(const Params& prm,
                                           unsigned char* smem,
                                           uint32_t bar, long long t,
                                           int s) {
  const long long rec0 = t * kTile;
  if (rec0 + kTile > prm.M) {
    mbar_expect_tx(bar, 0);
    return;
  }
  mbar_expect_tx(bar, prm.tx_bytes);
  const uint32_t stage = smem_u32(smem + s * prm.stage_bytes);
  for (int w = 0; w < prm.W; ++w) {
    if (!((prm.bulk >> w) & 1u)) continue;
    const int lg = static_cast<int>((prm.code >> (2 * w)) & 3u);
    bulk_load(stage + prm.off[w], prm.ptr[w] + (rec0 << lg), kTile << lg,
              bar);
  }
}

__global__ void __launch_bounds__(kThreads)
    interleave_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int tab[kMaxW];

  const int tid = threadIdx.x;
  const int W = prm.W;
  if (tid < W) {
    tab[tid] = (prm.off[tid] << 2) |
               static_cast<int>((prm.code >> (2 * tid)) & 3u);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (t >= prm.tiles) break;
      issue_tile(prm, smem, smem_u32(&full[s]), t, s);
    }
  }
  __syncthreads();

  const unsigned all = W == 32 ? ~0u : (1u << W) - 1u;
  int k = 0;
  for (long long t = blockIdx.x; t < prm.tiles; t += gridDim.x, ++k) {
    const int s = k % kStages;
    unsigned char* stage = smem + s * prm.stage_bytes;
    const long long rec0 = t * kTile;
    const long long left = prm.M - rec0;
    const int nrec = left < kTile ? static_cast<int>(left) : kTile;
    mbar_wait(smem_u32(&full[s]), (k / kStages) & 1);

    // planes the bulk copies did not bring, element by element
    const unsigned loose = nrec == kTile ? all & ~prm.bulk : all;
    if (loose) {
      for (int w = 0; w < W; ++w) {
        if (!((loose >> w) & 1u)) continue;
        const int lg = static_cast<int>((prm.code >> (2 * w)) & 3u);
        unsigned char* dst = stage + prm.off[w];
        const unsigned char* src = prm.ptr[w];
        for (int i = tid; i < nrec; i += kThreads) {
          if (lg == 0) {
            dst[i] = src[rec0 + i];
          } else if (lg == 1) {
            reinterpret_cast<int16_t*>(dst)[i] =
                reinterpret_cast<const int16_t*>(src)[rec0 + i];
          } else {
            reinterpret_cast<int32_t*>(dst)[i] =
                reinterpret_cast<const int32_t*>(src)[rec0 + i];
          }
        }
      }
      __syncthreads();
    }

    int32_t* dst = prm.out + rec0 * W;
    if (prm.vec_store) {
      const int q = W >> 2;
      const int chunks = nrec * q;
      int4* dst4 = reinterpret_cast<int4*>(dst);
      for (int c = tid; c < chunks; c += kThreads) {
        const int r = c / q;
        const int w = (c - r * q) * 4;
        int4 v;
        v.x = staged_word(stage, tab[w], r);
        v.y = staged_word(stage, tab[w + 1], r);
        v.z = staged_word(stage, tab[w + 2], r);
        v.w = staged_word(stage, tab[w + 3], r);
        dst4[c] = v;
      }
    } else {
      const int total = nrec * W;
      for (int e = tid; e < total; e += kThreads) {
        const int r = e / W;
        dst[e] = staged_word(stage, tab[e - r * W], r);
      }
    }
    __syncthreads();   // every thread is done with this stage

    if (tid == 0) {
      const long long next = t + static_cast<long long>(kStages) * gridDim.x;
      if (next < prm.tiles) {
        // order this block's generic accesses to the stage before the
        // async proxy's writes into it
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue_tile(prm, smem, smem_u32(&full[s]), next, s);
      }
    }
  }
}

// Per device: SM count, the dynamic shared memory the kernel may use, and
// the blocks per SM at the last stage size asked for.
struct DeviceInfo {
  int sms = 0;
  int smem_optin = 48 * 1024;
  int occ_smem = -1;
  int occ_blocks = 0;
};
DeviceInfo g_dev[kMaxDevices];

}  // namespace

extern "C" int interleave_launch(const void* ptrs, unsigned long long code,
                                 int W, long long M, int32_t* out,
                                 void* stream) {
  if (W < 1 || W > kMaxW || M < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const uintptr_t* p = static_cast<const uintptr_t*>(ptrs);
  Params prm;
  prm.bulk = 0;
  prm.tx_bytes = 0;
  int pos = 0;
  for (int w = 0; w < kMaxW; ++w) {
    if (w >= W) {
      prm.ptr[w] = nullptr;
      prm.off[w] = 0;
      continue;
    }
    const int lg = static_cast<int>((code >> (2 * w)) & 3u);
    if (lg > 2) return static_cast<int>(cudaErrorInvalidValue);
    // a 128-byte line, plus a stagger of 512 / W bytes per group of 4
    // planes (rounded to the 16 bytes a bulk copy needs): the warp's
    // transposed reads then spread over all banks
    const int stagger = (((w / 4) * 512 / W) & 127) & ~15;
    pos = ((pos + 127) & ~127) + stagger;
    prm.off[w] = pos;
    pos += kTile << lg;
    prm.ptr[w] = reinterpret_cast<const unsigned char*>(p[w]);
    if ((p[w] & 15u) == 0) {
      prm.bulk |= 1u << w;
      prm.tx_bytes += static_cast<unsigned>(kTile << lg);
    }
  }
  prm.code = code;
  prm.W = W;
  prm.stage_bytes = (pos + 127) & ~127;
  prm.vec_store =
      (W % 4 == 0) && ((reinterpret_cast<uintptr_t>(out) & 15u) == 0);
  prm.M = M;
  prm.tiles = (M + kTile - 1) / kTile;
  prm.out = out;
  const int smem = kStages * prm.stage_bytes;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceInfo& di = g_dev[dev];
  if (di.sms == 0) {
    err = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem > di.smem_optin) {
    err = cudaFuncSetAttribute(interleave_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    di.smem_optin = smem;
  }
  if (smem != di.occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &di.occ_blocks, interleave_kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    di.occ_smem = smem;
  }
  long long grid = static_cast<long long>(di.occ_blocks) * di.sms;
  if (grid < 1) grid = 1;
  if (grid > prm.tiles) grid = prm.tiles;
  interleave_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
