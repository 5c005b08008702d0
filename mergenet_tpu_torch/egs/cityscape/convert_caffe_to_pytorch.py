"""caffemodel -> npz weight archive of the port
(`egs/cityscape/local/convert_caffe_to_pytorch.py` is the reference; the
same flags): a thin CLI over `utils/caffe_import.py`, whose npz
`class_infer --caffe-weights` loads.

    python -m mergenet_tpu_torch.egs.cityscape.convert_caffe_to_pytorch \\
        --caffe-model M.caffemodel --out M.npz"""

import argparse

from ...utils.caffe_import import caffemodel_to_npz

parser = argparse.ArgumentParser(
    description="caffemodel -> npz weight converter")
parser.add_argument("--caffe-model", type=str, required=True)
parser.add_argument("--out", type=str, required=True,
                    help="output .npz path")


def main(argv=None):
    args = parser.parse_args(argv)
    names = caffemodel_to_npz(args.caffe_model, args.out)
    print("Wrote {} arrays to {}".format(len(names), args.out))
    for n in names[:10]:
        print("  ", n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
