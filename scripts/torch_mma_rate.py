"""The card's rate for the tensor-core instructions the port's mma.sync
kernels issue, for their floors:

    python scripts/torch_mma_rate.py

Builds a small kernel with nvcc (into build/mma_rate/) in which every warp
issues back-to-back ``mma.sync`` m16n8k8 TF32 (csrc/flare.cu, flare_bwd.cu,
flash_attention.cu's flash_tf32_kernel) or m16n8k16 bf16 (flare_causal.cu,
paged_attention.cu's paged_mla_tc_kernel) into 8 independent accumulators,
no memory traffic, 4 blocks an SM of 128, 256 or 512 threads, and prints
TFLOP/s from CUDA events (the second of two launches), then the card's name
and power limit. The published dense peaks (TF32 495, bf16 989 TFLOP/s) are
``wgmma``'s."""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void bench(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float run(int kind, int blocks, int threads, int iters) {
  float* out;
  if (cudaMalloc(&out, blocks * threads * sizeof(float)) != cudaSuccess) return -1.f;
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(start);
    if (kind == 0)
      bench<0><<<blocks, threads>>>(out, iters);
    else
      bench<1><<<blocks, threads>>>(out, iters);
    cudaEventRecord(end);
    cudaEventSynchronize(end);
  }
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, start, end);
  cudaFree(out);
  return ms;
}
"""


def main() -> int:
    build = ROOT / "build" / "mma_rate"
    build.mkdir(parents=True, exist_ok=True)
    (build / "mma_rate.cu").write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(build / "mma_rate.so"),
                    str(build / "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(str(build / "mma_rate.so"))
    lib.run.restype = ctypes.c_float
    lib.run.argtypes = [ctypes.c_int] * 4
    for kind, name, flop in ((0, "mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
                             (1, "mma.sync m16n8k16 bf16", 2 * 16 * 8 * 16)):
        for threads in (128, 256, 512):
            blocks, iters = 132 * 4, 4000
            ms = lib.run(kind, blocks, threads, iters)
            if ms <= 0:
                raise RuntimeError(f"{name}: the launch failed")
            mmas = blocks * threads // 32 * iters * 8
            print(f"{name}: {threads} threads a block x {blocks} blocks: {ms:.3f} ms, "
                  f"{mmas * flop / ms / 1e9:.1f} TFLOP/s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
