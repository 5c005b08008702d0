"""COCO recipes of the port (`egs/coco/local` is the reference): train,
segment (with the oracle mode), evaluate, and run_pspfpnet_crop.sh."""
