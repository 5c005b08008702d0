#!/bin/bash
# UperNet staged inference with the PyTorch port: class_infer ->
# offset_infer -> segment -> evaluate (the twin of the JAX recipe's
# infer_upernet.sh: infer_pspfpnet.sh's stages with the upernet arch,
# without the submission).  Every stage is a `python3 -m
# mergenet_tpu_torch.egs.cityscape.<stage>`; a failing stage stops the
# script with its exit code.

stage=0
dir=exp/upernet50
arch=upernet
class_dir=exp/cls/upernet50
offset_dir=exp/ofs/upernet50
class_model=      # default: $class_dir/model_best
offset_model=     # default: $offset_dir/model_best
decoder=device
num_jobs=1
img=data/val
ann=data/annotations/instancesonly_filtered_gtFine_val.json
device=cuda

here=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
export PYTHONPATH=$here/../../..${PYTHONPATH:+:$PYTHONPATH}
. $here/../parse_options.sh
class_model=${class_model:-$class_dir/model_best}
offset_model=${offset_model:-$offset_dir/model_best}
run="python3 -m mergenet_tpu_torch.egs.cityscape"
t0=$(date +%s%N)
stage_done() {  # prints "<script>: stage <n> done in <ms> ms"
  local t=$(date +%s%N)
  echo "$0: stage $1 done in $(( (t - t0) / 1000000 )) ms"
  t0=$t
}

mkdir -p $dir

if [ $stage -le 0 ]; then
  echo "$0: Doing class inference....."
  $run.class_infer \
          --dir $class_dir \
          --model $class_model \
          --arch $arch \
          --img $img --ann $ann --device $device \
          --score || exit 1
  stage_done 0
fi

if [ $stage -le 1 ]; then
  echo "$0: Doing offset inference....."
  $run.offset_infer \
          --dir $offset_dir \
          --model $offset_model \
          --arch $arch \
          --img $img --ann $ann --device $device \
          --score || exit 1
  stage_done 1
fi

segdir=segment_512
mkdir -p $dir/$segdir/img $dir/$segdir/pkl $dir/$segdir/result

if [ $stage -le 2 ]; then
  echo "$0: Doing segmentation...."
  pids=""
  for job in $(seq 1 $num_jobs); do
    $run.segment \
            --dir $dir \
            --class-dir $class_dir \
            --offset-dir $offset_dir \
            --segment $segdir \
            --decoder $decoder \
            --img $img --ann $ann --device $device \
            --job $job --num-jobs $num_jobs \
            --visualize &
    pids="$pids $!"
  done
  for pid in $pids; do
    wait $pid || exit 1
  done
  stage_done 2
fi

if [ $stage -le 3 ]; then
  echo "$0: Doing evaluation..."
  $run.evaluate \
          --segment-dir $dir/$segdir --val-ann $ann || exit 1
  stage_done 3
fi
