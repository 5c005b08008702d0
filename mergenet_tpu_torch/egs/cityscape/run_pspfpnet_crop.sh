#!/bin/bash
# Train the pspfpnet on Cityscapes crops with the PyTorch port (the twin
# of the JAX recipe's run_pspfpnet_crop.sh).  Data-parallel over N cards:
#   ./run_pspfpnet_crop.sh --nproc N   (torchrun --nproc_per_node N)

train_image_size=768
epochs=400
dir=exp/crop/pspfpnet50_alpha20
batch_size=16
train_img=data/train
val_img=data/val
train_ann=data/annotations/instancesonly_filtered_gtFine_train.json
val_ann=data/annotations/instancesonly_filtered_gtFine_val.json
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
$launch mergenet_tpu_torch.egs.cityscape.train \
        --epochs $epochs \
        --crop-size $train_image_size \
        --batch-size $batch_size \
        --alpha 20 \
        --arch pspfpnet \
        --log-freq 100 \
        --pretrain \
        --tensorboard \
        --crop \
        --train-img $train_img --val-img $val_img \
        --train-ann $train_ann --val-ann $val_ann \
        --device $device \
        $dir || exit 1
