#!/bin/bash
# The PyTorch port's twin of scripts/car/vob/train_rcnn.sh (run from anywhere; it cds to the repo root).
# Stage 4: PointRCNN 3D RCNN training (reference scripts/car/vob/train_rcnn.sh):
# the RPN stage's weights seed the RCNN stage (iteration reset = fresh
# optimizer, MODEL.WEIGHT instead of the reference's ckpt file copy).
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.train_net --config-file configs/kitti/car/vob/rcnn.yaml \
    "$@" MODEL.WEIGHT models/kitti/car/vob/rpn/ckpt
