#!/usr/bin/env bash
# Metachronal-wavelength sweep on the PyTorch/CUDA port — scripts/sweep.sh
# with the port's CLI in place of the JAX package's: the counterpart of
# the reference's cluster launch scripts (CUDA_IBLB_11/{app,cilia6,
# cilia12,multiapp}.sh), which swept c_fraction for fixed c_num with
#   ./app <c_fraction> <c_num> <c_space> <Re> <T_num> <T_pow> <I_pow> <P_num> <ShARC> <BigData>
#
# Usage: cuda_iblb_11_tpu_torch/sweep.sh [c_num] [c_space] [output_root] [CLI flags ...]
# Runs on the card; any further arguments go to every CLI call (e.g.
# --device cpu for the plain versions on the CPU).
set -euo pipefail

C_NUM="${1:-6}"
C_SPACE="${2:-48}"
OUT="${3:-Data/Sweep}"

for C_FRACTION in 1 2 3; do
    echo "=== c_fraction=${C_FRACTION} c_num=${C_NUM} ==="
    python -m cuda_iblb_11_tpu_torch.cli \
        "${C_FRACTION}" "${C_NUM}" "${C_SPACE}" 1.0 1.0 5 1 100 0 0 \
        --output "${OUT}" --dtype float32 "${@:4}"
done
