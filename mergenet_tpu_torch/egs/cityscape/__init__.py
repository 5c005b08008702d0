"""Cityscapes recipes of the port (`egs/cityscape/local` is the
reference): train, class_infer, offset_infer, segment, infer_e2e,
evaluate, submit, make_synthetic_data, convert_caffe_to_pytorch,
convert_cityscapes_to_coco (with its cityscapes_labels table), and the
shell drivers run_pspfpnet_crop.sh, infer_pspfpnet.sh, infer_upernet.sh
and prepare_data.sh."""
