#!/bin/bash
# The flagship recipe through dss_tpu_torch on the CUDA card (the port's
# counterpart of scripts/train_flagship.sh; same stages, same arguments):
#   1. configs/dss_depth.yml      — coarse convergence + dense-depth L1
#   2. configs/dss_depth_fine.yml — pixel-scale silhouette refinement
#   3. apps/prune_floaters --depth-tol — interior-floater removal
#   4. apps/refine_normals        — jet normal fit on the pruned cloud
# RUN_HIRES=1 inserts the 1024² depth phase (configs/dss_depth_hires.yml)
# before the post-process.  DEVICE=cpu runs every stage on the CPU.
# Usage: bash scripts/train_flagship_torch.sh [data_dir_512] [data_dir_1024]
set -euo pipefail
cd "$(dirname "$0")/.."
DATA="${1:-/tmp/yoga6_data}"
DATA_HIRES="${2:-/tmp/yoga6_1024x128}"
DEV=()
if [ -n "${DEVICE:-}" ]; then DEV=(--device "$DEVICE"); fi

if [ ! -d "$DATA" ]; then
  echo "dataset $DATA missing — generate it first from the GT mesh with:" >&2
  echo "  python3 -m dss_tpu_torch.apps.create_mvr_data --mesh <gt>.ply --out $DATA" >&2
  echo "or a synthetic sphere with:" >&2
  echo "  python3 -m dss_tpu_torch.apps.make_tiny_dataset --out $DATA" >&2
  exit 1
fi
if [ ! -d "$DATA/depth" ]; then
  echo "dataset $DATA has no dense depth maps; write them for its own" >&2
  echo "cameras with:" >&2
  echo "  python3 -m dss_tpu_torch.apps.gen_depth_for_dataset --data $DATA --mesh <gt>.ply" >&2
  exit 1
fi

python3 -m dss_tpu_torch.apps.train_mvr --config configs/dss_depth.yml \
  --max-iters 6000 --data-dir "$DATA" "${DEV[@]}"
mkdir -p exp/dss_depth_fine
cp exp/dss_depth/model_best.npz exp/dss_depth_fine/model.npz
python3 -m dss_tpu_torch.apps.train_mvr --config configs/dss_depth_fine.yml \
  --max-iters 14000 --data-dir "$DATA" "${DEV[@]}"

FINAL_DIR=exp/dss_depth_fine
if [ "${RUN_HIRES:-0}" = "1" ]; then
  if [ ! -d "$DATA_HIRES" ]; then
    echo "hi-res dataset $DATA_HIRES missing" >&2
    exit 1
  fi
  mkdir -p exp/dss_depth_hires
  cp exp/dss_depth_fine/model_best.npz exp/dss_depth_hires/model.npz
  python3 -m dss_tpu_torch.apps.train_mvr --config configs/dss_depth_hires.yml \
    --max-iters 18000 --data-dir "$DATA_HIRES" "${DEV[@]}"
  FINAL_DIR=exp/dss_depth_hires
fi

python3 -m dss_tpu_torch.apps.prune_floaters \
  --ckpt "$FINAL_DIR/model_best.npz" --data "$DATA" \
  --depth-tol 0.03 --depth-min-views 3 "${DEV[@]}"
python3 -m dss_tpu_torch.apps.refine_normals \
  --ckpt "$FINAL_DIR/model_best_pruned.npz" --data "$DATA" \
  --jet-passes 3 "${DEV[@]}"
echo "final model: $FINAL_DIR/model_best_pruned_jet.npz (+ .ply)"
