#!/bin/bash
# The PyTorch port's twin of scripts/pedestrian/pob/eval_rcnn.sh (run from anywhere; it cds to the repo root).
# Full-pipeline evaluation (reference scripts/pedestrian/pob/eval_rcnn.sh):
# offline 2D preds -> iDispNet -> PointRCNN -> KITTI txt (+ AP if --evaluate).
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/pedestrian/pob/rcnn.yaml "$@"
