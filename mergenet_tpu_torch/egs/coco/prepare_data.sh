#!/bin/bash
# Link COCO-2017 for the PyTorch port's recipes (the twin of the JAX
# recipe's prepare_data.sh).  Expects train2017/, val2017/ and
# annotations/ under $download_dir.
#   ./prepare_data.sh [--download-dir data/coco_download] [--out-dir data]

download_dir=data/coco_download
out_dir=data

here=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
export PYTHONPATH=$here/../../..${PYTHONPATH:+:$PYTHONPATH}
. $here/../parse_options.sh

mkdir -p $out_dir
for d in train2017 val2017 annotations; do
  if [ -d "$download_dir/$d" ] && [ ! -e "$out_dir/$d" ]; then
    ln -sf "$(realpath $download_dir/$d)" "$out_dir/$d"
  fi
done
echo "$0: Done."
