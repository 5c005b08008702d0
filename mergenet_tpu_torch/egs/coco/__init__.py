"""COCO recipes of the port (`egs/coco/local` is the reference): train,
segment (with the oracle mode), evaluate, and the shell drivers
run_pspfpnet_crop.sh and prepare_data.sh."""
