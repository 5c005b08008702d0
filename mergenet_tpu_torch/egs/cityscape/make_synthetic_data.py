"""Synthetic street-like COCO dataset of the port
(`egs/cityscape/local/make_synthetic_data.py` is the reference; the
same flags): a thin CLI over `data/synthetic.py`, which writes the same
files.

    python -m mergenet_tpu_torch.egs.cityscape.make_synthetic_data \\
        --out-dir data [--train-images 60 --val-images 12 ...]"""

from ...data.synthetic import main

if __name__ == "__main__":
    main()
