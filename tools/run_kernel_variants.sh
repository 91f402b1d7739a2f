#!/bin/bash
# Build and run the design-variant timings of the wide assign tile and the
# one-read rmsnorm backward (tools/*_variants.cu) on a machine with the card;
# the binaries go under build/ (git-ignored).  One JSON line a measurement,
# after the card's name and power limit.
#   bash tools/run_kernel_variants.sh
set -euo pipefail
cd "$(dirname "$0")/.."
NVCC="${CUDA_HOME:-/usr/local/cuda}/bin/nvcc"
mkdir -p build/tools
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in assign_wide_variants rmsnorm_bwd_variants; do
  "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
    -o "build/tools/$t" "tools/$t.cu" &
done
wait
build/tools/assign_wide_variants
build/tools/rmsnorm_bwd_variants
