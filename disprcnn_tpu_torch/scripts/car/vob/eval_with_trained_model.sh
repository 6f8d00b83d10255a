#!/bin/bash
# The PyTorch port's twin of scripts/car/vob/eval_with_trained_model.sh (run from anywhere; it cds to the repo root).
# Evaluate the RELEASED checkpoints (reference scripts/car/vob/eval_with_trained_model.sh):
# place the downloaded artifacts under models/kitti/car/vob/ (there is no
# download) — the importer sniffs each torch layout automatically.
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/vob/mask.yaml \
    --ckpt models/kitti/car/vob/mask/smrcnn.pth --dataset kitti_val_vob_car "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/vob/idispnet.yaml \
    --dataset kitti_val_vob_car "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/vob/rcnn.yaml \
    --ckpt models/kitti/car/vob/rcnn/pointrcnn.pth --dataset kitti_val_vob_car "$@"
