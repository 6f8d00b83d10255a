#!/bin/bash
# The PyTorch port's twin of scripts/cyclist/train_rpn.sh (run from anywhere; it cds to the repo root).
# Stage 3: PointRCNN 3D RPN training (reference scripts/cyclist/train_rpn.sh):
# refresh the offline predictions from the idispnet stage, then train the
# 3D RPN initialized from the idispnet checkpoint.
set -e
cd "$(dirname "$0")/../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/cyclist/idispnet.yaml \
    --dataset kitti_train_cyclist $IDISP_ARGS
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/cyclist/idispnet.yaml \
    --dataset kitti_val_cyclist $IDISP_ARGS
python -m disprcnn_tpu_torch.tools.train_net --config-file configs/kitti/cyclist/rpn.yaml \
    "$@" MODEL.WEIGHT models/kitti/cyclist/idispnet/ckpt
