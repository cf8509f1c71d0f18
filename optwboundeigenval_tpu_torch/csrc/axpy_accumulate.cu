// In-place accumulate over a list of leaves, in one launch, for Hopper (sm_90a):
//
//   acc_l[i] = acc_l[i] + alpha * delta_l[i]      (accumulate)
//   acc_l[i] = alpha * delta_l[i]                 (init: acc is never read)
//
// for every leaf l of a parameter tree, in float32, float64 or bfloat16.
//
// Replaces the Pallas TPU kernel optwboundeigenval_tpu/ops/pallas_kernels.py
// ::axpy_accumulate (the running sum of the micro-batched HVP, gradient and
// vGHv), which the JAX package calls once per leaf.
//
// Bound: memory.  Per element it reads acc and delta and writes acc: 12 bytes
// in float32 (8 under init), no reuse, 2 flops.  A DenseNet-40 tree is 119
// leaves and 2.1 MB, far too little work to hide one launch per leaf, so one
// launch covers the whole tree:
//
// * The per-leaf table {acc, delta, n, first_chunk, aligned} is a kernel
//   parameter passed by value (__grid_constant__, up to 32,764 bytes of
//   parameters on sm_90 since CUDA 12.1).  No host-to-device copy and no
//   device-side table to keep valid: the delta pointers are fresh tensors on
//   every call.  The table holds kCap leaves; the caller splits a longer list
//   into ceil(leaves / kCap) launches.
// * The leaves are cut, one after the other, into chunks of kChunkBytes (256
//   threads x 2 16-byte vectors).  One block per chunk, grid-stride over the
//   chunks when there are more than resident blocks.  A block finds its leaf
//   by a binary search over first_chunk; every thread reads the same address,
//   so parameter space broadcasts it through the constant cache.
// * 16-byte loads and stores (float4, double2) where both pointers of a leaf
//   are 16-byte aligned, scalar ones otherwise; the tail of a leaf is masked,
//   where the TPU version zero-padded to (512, 128) tiles.
// * alpha is read from device memory, so the micro-batch weight never syncs
//   the host.  Nothing is allocated and nothing is synchronised.
// * bfloat16 leaves (the gemm CNNUSPS at bfloat16 compute holds its conv
//   parameters in bfloat16, so its gradient, HVP and vGHv trees mix
//   bfloat16 and float32 leaves): the caller launches once per dtype of the
//   tree.  Each bfloat16 value is loaded, widened to float32 (exact), the
//   sum is taken in float32 against a float32 alpha, and it is rounded once,
//   to nearest even, on the store: 6 bytes a value (4 under init).  This is
//   the JAX trainer's a + scale * d on such a leaf (float32 by promotion)
//   cast back to the leaf's dtype; the Pallas kernel itself refuses
//   bfloat16.
//
// The sum is rounded as fl(acc + fl(alpha * delta)): __fmul_rn / __fadd_rn
// (__dmul_rn / __dadd_rn) keep nvcc from contracting it into one fma, so the
// kernel agrees bit for bit with the plain PyTorch version acc.add_(delta *
// alpha) and with the JAX accumulate a + scale * d.  Under init it writes
// fl(alpha * delta), which is fl(0 + fl(alpha * delta)) but for the sign of an
// exact zero.  In bfloat16 both are taken in float32 and rounded to bfloat16
// once at the end, as the plain version's (acc.float() + alpha *
// delta.float()).to(torch.bfloat16).

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCap = 1024;           // leaves per launch
constexpr int kThreads = 256;
constexpr int kVecPerThread = 2;     // 16-byte vectors per thread per chunk
constexpr int kChunkBytes = kThreads * kVecPerThread * 16;
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident blocks at full occupancy
constexpr int kRowWords = 5;         // acc, delta, n, first_chunk, aligned

template <typename T>
struct Table {
  T* acc[kCap];
  const T* delta[kCap];
  long long n[kCap];
  int first_chunk[kCap];  // first chunk of leaf l in the launch's chunk order
  unsigned char aligned[kCap];
  int leaves;
};

// the kernel's parameters: the table, alpha and the chunk count
static_assert(sizeof(Table<double>) + sizeof(void*) + sizeof(int) <= 32764,
              "the leaf table must fit in the 32,764 bytes of kernel parameters");

// the storage type T of a leaf: its 16-byte vector V and the type C the sum
// is taken in (float for bfloat16)
template <typename T> struct Traits;
template <> struct Traits<float> { using V = float4; using C = float; };
template <> struct Traits<double> { using V = double2; using C = double; };
template <> struct Traits<__nv_bfloat16> { using V = uint4; using C = float; };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(typename Traits<T>::C x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ double narrow<double>(double x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // the one rounding of a bfloat16 sum
}

template <typename T, bool kInit>
__device__ __forceinline__ T axpy_value(T acc, T delta, typename Traits<T>::C a) {
  const typename Traits<T>::C d = mul_rn(a, widen(delta));
  return narrow<T>(kInit ? d : add_rn(widen(acc), d));
}

template <typename T, bool kInit>
__device__ __forceinline__ void axpy_scalar(T* acc, const T* delta,
                                            typename Traits<T>::C a) {
  *acc = axpy_value<T, kInit>(kInit ? *delta : *acc, *delta, a);
}

template <typename T, bool kInit>
__global__ void __launch_bounds__(kThreads)
axpy_tree_kernel(const __grid_constant__ Table<T> table,
                 const typename Traits<T>::C* __restrict__ alpha, int chunks) {
  using V = typename Traits<T>::V;
  constexpr int kWidth = 16 / sizeof(T);
  constexpr int kChunk = kChunkBytes / sizeof(T);
  const typename Traits<T>::C a = *alpha;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    // the leaf of chunk c: the last leaf whose first chunk is <= c
    int lo = 0, hi = table.leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table.first_chunk[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const long long start = (long long)(c - table.first_chunk[lo]) * kChunk;
    const int m = (int)min((long long)kChunk, table.n[lo] - start);
    T* acc = table.acc[lo] + start;
    const T* delta = table.delta[lo] + start;
    if (table.aligned[lo]) {
      V* acc_v = reinterpret_cast<V*>(acc);
      const V* delta_v = reinterpret_cast<const V*>(delta);
      const int nv = m / kWidth;
      V x[kVecPerThread], d[kVecPerThread];
#pragma unroll
      for (int j = 0; j < kVecPerThread; ++j) {
        const int k = j * kThreads + threadIdx.x;
        if (k < nv) {
          d[j] = delta_v[k];
          if (!kInit) x[j] = acc_v[k];
        }
      }
#pragma unroll
      for (int j = 0; j < kVecPerThread; ++j) {
        const int k = j * kThreads + threadIdx.x;
        if (k < nv) {
          T* xs = reinterpret_cast<T*>(&x[j]);
          const T* ds = reinterpret_cast<const T*>(&d[j]);
#pragma unroll
          for (int e = 0; e < kWidth; ++e) {
            xs[e] = axpy_value<T, kInit>(kInit ? ds[e] : xs[e], ds[e], a);
          }
          acc_v[k] = x[j];
        }
      }
      const int k = nv * kWidth + threadIdx.x;  // masked tail: < kWidth elements
      if (k < m) axpy_scalar<T, kInit>(acc + k, delta + k, a);
    } else {
      for (int k = threadIdx.x; k < m; k += kThreads) {
        axpy_scalar<T, kInit>(acc + k, delta + k, a);
      }
    }
  }
}

// rows: `leaves` rows of kRowWords int64 {acc, delta, n, first_chunk, aligned},
// leaves with n > 0 only, first_chunk ascending from 0; chunks: the chunk
// count of the whole table.
template <typename T>
int launch(const long long* rows, long long leaves, long long chunks,
           const void* alpha, long long init, void* stream) {
  if (leaves < 0 || leaves > kCap || chunks < 0 || chunks > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (leaves == 0 || chunks == 0) return (int)cudaSuccess;
  Table<T> t;  // only the first `leaves` rows are read by the kernel
  for (long long l = 0; l < leaves; ++l) {
    const long long* r = rows + kRowWords * l;
    t.acc[l] = reinterpret_cast<T*>(static_cast<std::uintptr_t>(r[0]));
    t.delta[l] = reinterpret_cast<const T*>(static_cast<std::uintptr_t>(r[1]));
    t.n[l] = r[2];
    t.first_chunk[l] = (int)r[3];
    t.aligned[l] = r[4] ? 1 : 0;
  }
  t.leaves = (int)leaves;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * kBlocksPerSm;
  const int grid = (int)(chunks < resident ? chunks : resident);
  const auto* s = static_cast<const typename Traits<T>::C*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (init) {
    axpy_tree_kernel<T, true><<<grid, kThreads, 0, st>>>(t, s, (int)chunks);
  } else {
    axpy_tree_kernel<T, false><<<grid, kThreads, 0, st>>>(t, s, (int)chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The table's capacity in leaves and the chunk size in bytes, for the
// wrapper to check against its own packing.
extern "C" int axpy_tree_capacity() { return kCap; }
extern "C" int axpy_tree_chunk_bytes() { return kChunkBytes; }

// One launch over a table of float32 (float64, bfloat16) leaves on `stream`;
// alpha is one value of the same type on the device (float32 for bfloat16
// leaves).  Returns cudaGetLastError() (cudaSuccess when there was nothing to
// launch).
extern "C" int axpy_accumulate_tree_f32(const void* rows, long long leaves,
                                        long long chunks, const void* alpha,
                                        long long init, void* stream) {
  return launch<float>(static_cast<const long long*>(rows), leaves, chunks,
                       alpha, init, stream);
}

extern "C" int axpy_accumulate_tree_f64(const void* rows, long long leaves,
                                        long long chunks, const void* alpha,
                                        long long init, void* stream) {
  return launch<double>(static_cast<const long long*>(rows), leaves, chunks,
                        alpha, init, stream);
}

extern "C" int axpy_accumulate_tree_bf16(const void* rows, long long leaves,
                                         long long chunks, const void* alpha,
                                         long long init, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const long long*>(rows), leaves, chunks,
                               alpha, init, stream);
}
