#!/bin/bash
# The PyTorch port's twin of scripts/pedestrian/vob/train_smrcnn.sh (run from anywhere; it cds to the repo root).
# Stage 1: stereo Mask R-CNN 2D training (reference scripts/pedestrian/vob/train_smrcnn.sh).
# Extra args are forwarded (e.g. --max-iter 2 for smoke runs, KEY VALUE overrides).
set -e
cd "$(dirname "$0")/../../../.."
python -m disprcnn_tpu_torch.tools.train_net --config-file configs/kitti/pedestrian/vob/mask.yaml "$@"
