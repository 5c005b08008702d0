"""The recipes of the port (`egs/cityscape/local/*.py` and
`egs/coco/local/*.py` are the reference): one module per script, run as
`python -m mergenet_tpu_torch.egs.<dataset>.<stage>` with the
reference's flags plus `--device` (default cuda), and shell drivers
beside them.  `common.py` holds what the reference's scripts repeat."""
