#!/bin/bash
# The PyTorch port's twin of scripts/car/pob/train_rpn.sh (run from anywhere; it cds to the repo root).
# Stage 3: PointRCNN 3D RPN training (reference scripts/car/pob/train_rpn.sh):
# refresh the offline predictions from the idispnet stage, then train the
# 3D RPN initialized from the idispnet checkpoint.
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/pob/idispnet.yaml \
    --dataset kitti_train_pob_car $IDISP_ARGS
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/pob/idispnet.yaml \
    --dataset kitti_val_pob_car $IDISP_ARGS
python -m disprcnn_tpu_torch.tools.train_net --config-file configs/kitti/car/pob/rpn.yaml \
    "$@" MODEL.WEIGHT models/kitti/car/pob/idispnet/ckpt
