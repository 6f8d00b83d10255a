#!/usr/bin/env bash
# Runs the eval CLI (python -m disprcnn_tpu_torch.tools.test_net) as its own
# processes on the card, as a user would: rcnn.yaml on synthetic3d_8 and
# mask.yaml on synthetic_8, each with --evaluate against the first 8
# synthetic scenes' GT (chip_smoke.write_kitti_gt), random weights, the
# default --device cuda. Prints the card's name and power limit, each
# process's log (images/s and the loop's split) and its wall time.
#
#   bash disprcnn_tpu_torch/tools/run_eval_cli.sh OUT_DIR
#
# Run from the root of the repo; OUT_DIR/{rcnn,mask}/log.txt keep the logs.
set -e
out=${1:?usage: run_eval_cli.sh OUT_DIR}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python -c "from disprcnn_tpu_torch.ops.cuda import build; build.build(*build.SOURCES)"
rm -rf "$out" && mkdir -p "$out"
python -c "import chip_smoke as c; print('GT instances', c.write_kitti_gt('$out/gt', 8))"
set +e
for spec in "rcnn synthetic3d_8" "mask synthetic_8"; do
  set -- $spec
  t0=$EPOCHREALTIME
  python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/vob/$1.yaml \
      --dataset $2 --evaluate --gt-dir "$out/gt" OUTPUT_DIR "$out/$1"
  rc=$?
  echo "CLI $1 rc=$rc process_s=$(python -c "print($EPOCHREALTIME - $t0)")"
  rm -f "$out/$1/inference/$2/predictions.pkl"
  [ $rc = 0 ] || exit $rc
done
