#!/bin/bash
# Train pspfpnet on COCO crops with the PyTorch port (the twin of the JAX
# recipe's coco run_pspfpnet_crop.sh).  Data-parallel over N cards:
#   ./run_pspfpnet_crop.sh --nproc N   (torchrun --nproc_per_node N)

train_image_size=384
epochs=400
dir=exp/crop/pspfpnet50
nproc=0
device=cuda

here=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
export PYTHONPATH=$here/../../..${PYTHONPATH:+:$PYTHONPATH}
. $here/../parse_options.sh

launch="python3 -m"
if [ $nproc -gt 0 ]; then
  launch="torchrun --standalone --nproc_per_node $nproc -m"
fi

echo "$0: Training the network....."
$launch mergenet_tpu_torch.egs.coco.train \
        --epochs $epochs \
        --crop-size $train_image_size \
        --scale 2 \
        --arch pspfpnet \
        --log-freq 100 \
        --pretrain \
        --tensorboard \
        --device $device \
        $dir || exit 1
