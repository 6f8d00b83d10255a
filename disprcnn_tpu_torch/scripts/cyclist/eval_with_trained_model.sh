#!/bin/bash
# The PyTorch port's twin of scripts/cyclist/eval_with_trained_model.sh (run from anywhere; it cds to the repo root).
# Evaluate the RELEASED checkpoints (reference scripts/cyclist/eval_with_trained_model.sh):
# place the downloaded artifacts under models/kitti/cyclist/ (there is no
# download) — the importer sniffs each torch layout automatically.
set -e
cd "$(dirname "$0")/../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/cyclist/mask.yaml \
    --ckpt models/kitti/cyclist/mask/smrcnn.pth --dataset kitti_val_cyclist "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/cyclist/idispnet.yaml \
    --dataset kitti_val_cyclist "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/cyclist/rcnn.yaml \
    --ckpt models/kitti/cyclist/rcnn/pointrcnn.pth --dataset kitti_val_cyclist "$@"
