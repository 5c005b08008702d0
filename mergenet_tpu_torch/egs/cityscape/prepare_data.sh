#!/bin/bash
# Prepare Cityscapes data with the PyTorch port (the twin of the JAX
# recipe's prepare_data.sh): expects the leftImg8bit + gtFine downloads,
# converts the annotations to COCO json and symlinks the images.
#   ./prepare_data.sh [--dataset-dir data/cityscapes_download] [--out-dir data]

dataset_dir=data/cityscapes_download
out_dir=data

here=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
export PYTHONPATH=$here/../../..${PYTHONPATH:+:$PYTHONPATH}
. $here/../parse_options.sh

mkdir -p $out_dir/annotations

echo "$0: Converting Cityscapes annotations to COCO format..."
python3 -m mergenet_tpu_torch.egs.cityscape.convert_cityscapes_to_coco \
        --dataset-dir $dataset_dir \
        --out-dir $out_dir/annotations || exit 1

echo "$0: Linking image directories..."
for split in train val test; do
  mkdir -p $out_dir/$split
  src=$dataset_dir/leftImg8bit_trainvaltest/leftImg8bit/$split
  if [ -d "$src" ]; then
    find $src -name '*_leftImg8bit.png' | while read f; do
      ln -sf "$(realpath $f)" $out_dir/$split/
    done
  fi
done
echo "$0: Done."
