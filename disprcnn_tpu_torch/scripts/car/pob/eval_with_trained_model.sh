#!/bin/bash
# The PyTorch port's twin of scripts/car/pob/eval_with_trained_model.sh (run from anywhere; it cds to the repo root).
# Evaluate the RELEASED checkpoints (reference scripts/car/pob/eval_with_trained_model.sh):
# place the downloaded artifacts under models/kitti/car/pob/ (there is no
# download) — the importer sniffs each torch layout automatically.
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/pob/mask.yaml \
    --ckpt models/kitti/car/pob/mask/smrcnn.pth --dataset kitti_val_pob_car "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/pob/idispnet.yaml \
    --dataset kitti_val_pob_car "$@"
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/pob/rcnn.yaml \
    --ckpt models/kitti/car/pob/rcnn/pointrcnn.pth --dataset kitti_val_pob_car "$@"
