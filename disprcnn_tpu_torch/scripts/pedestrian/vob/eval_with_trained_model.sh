#!/bin/bash
# The PyTorch port's twin of scripts/pedestrian/vob/eval_with_trained_model.sh (run from anywhere; it cds to the repo root).
# Evaluate the RELEASED checkpoints (reference scripts/pedestrian/vob/eval_with_trained_model.sh):
# place the downloaded artifacts under models/kitti/pedestrian/vob/ (there is no
# download) — the importer sniffs each torch layout automatically.
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/pedestrian/vob/mask.yaml \
    --ckpt models/kitti/pedestrian/vob/mask/smrcnn.pth --dataset kitti_val_vob_pedestrian "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/pedestrian/vob/idispnet.yaml \
    --dataset kitti_val_vob_pedestrian "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/pedestrian/vob/rcnn.yaml \
    --ckpt models/kitti/pedestrian/vob/rcnn/pointrcnn.pth --dataset kitti_val_vob_pedestrian "$@"
