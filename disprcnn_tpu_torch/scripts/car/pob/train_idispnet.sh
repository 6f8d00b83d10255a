#!/bin/bash
# The PyTorch port's twin of scripts/car/pob/train_idispnet.sh (run from anywhere; it cds to the repo root).
# Stage 2: iDispNet training (reference scripts/car/pob/train_idispnet.sh):
# 1) run 2D inference on train+val to produce the offline predictions,
# 2) train the in-framework iDispNet (DispRCNN3D + SOLVER.TRAIN_PSM).
# Pass MASK_ARGS / TRAIN_ARGS env vars for smoke overrides.
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/pob/mask.yaml \
    --dataset kitti_train_pob_car $MASK_ARGS
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/pob/mask.yaml \
    --dataset kitti_val_pob_car $MASK_ARGS
python -m disprcnn_tpu_torch.tools.train_net --config-file configs/kitti/car/pob/idispnet.yaml "$@"
