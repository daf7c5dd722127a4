// Stand-ins that let a CUDA C++ kernel source compile as C++20 for the CPU,
// one std::thread per CUDA thread of a block: __syncwarp and __syncthreads
// become a barrier over the block's threads (a stronger sync than the warp's,
// which every thread of the kernel reaches equally often), __ldg a plain load,
// __constant__ and __launch_bounds__ nothing.  Used by
// tests/test_torch_kernel_on_cpu.py.
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(...)
struct CpuIdx { int x; };
thread_local CpuIdx threadIdx, blockIdx;
thread_local std::barrier<>* cpu_block_barrier;
thread_local float* cpu_block_smem;
inline void __syncwarp() { cpu_block_barrier->arrive_and_wait(); }
inline void __syncthreads() { cpu_block_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
using std::max;
using std::min;
