"""Combined-image / image-with-mask validation (a copy of
`mergenet_tpu/core/types.py`; numpy only).

Capability parity with reference `utils/data_types.py:8-119`: validators for
the {img, mask, object_class} dict spec and the "combined image" tensor
(num_colors + num_classes + num_offsets label planes).  The combined image
here is channel-last (height, width, num_channels) — the TPU layout — with
the same channel ordering: colors, then class planes, then offset planes.
"""

import numpy as np

from .config import CoreConfig


def validate_config(c, train_image_size=None):
    """Validates that `c` is a valid CoreConfig."""
    assert isinstance(c, CoreConfig)
    c.validate(train_image_size)


def validate_image_with_mask(x, c):
    """Validate an {img, mask, object_class} dict against config `c`.

    img: (height, width[, num_colors]) array; mask: integer (height, width)
    array of object ids; object_class: list of per-object class ids in
    [0, num_classes)."""
    validate_config(c)
    if not isinstance(x, dict):
        raise ValueError("dict type input required.")
    if "img" not in x or "mask" not in x or "object_class" not in x:
        raise ValueError(
            "img, mask and object_class required in the dict input.")
    if not isinstance(x["img"], np.ndarray):
        raise ValueError("ndarray type img object required.")
    if not isinstance(x["mask"], np.ndarray):
        raise ValueError("ndarray type mask object required.")
    if not isinstance(x["object_class"], list):
        raise ValueError("list type object_class required.")

    im = x["img"]
    if c.num_colors == 1:
        if im.ndim != 2:
            raise ValueError("2 dimensional image required.")
    else:
        if im.ndim != 3:
            raise ValueError("3 dimensional image required.")

    mask = x["mask"]
    if mask.ndim != 2 or mask.shape[0] != im.shape[0] or \
            mask.shape[1] != im.shape[1]:
        raise ValueError("same mask shape and image shape required.")
    if not issubclass(np.unique(mask).dtype.type, np.integer):
        raise ValueError("int type mask value required.")

    # note: the reference used `set(..) > set(range(n))` here, which is a
    # proper-superset test and never fires for out-of-range ids — fixed to
    # an actual containment check
    if not set(x["object_class"]) <= set(range(c.num_classes)):
        raise ValueError("object classes between 0 and num_classes required")


def validate_combined_image(x, c):
    """Validate a combined image: (height, width, num_channels) with
    num_channels = num_colors + num_classes + num_offsets; the label planes
    (beyond the colors) must be {0, 1} valued (spot-checked randomly, as in
    the reference)."""
    validate_config(c)
    if not isinstance(x, np.ndarray):
        raise ValueError("x of numpy array type required.")
    if x.ndim != 3:
        raise ValueError("3 dimensional image required.")
    dim = c.num_colors + c.num_classes + len(c.offsets)
    if x.shape[-1] != dim:
        raise ValueError(
            "channel dimension should match num_colors + num_classes + "
            "num_offsets")
    k = np.random.randint(c.num_colors, x.shape[-1])
    i = np.random.randint(0, x.shape[0])
    j = np.random.randint(0, x.shape[1])
    if not (x[i, j, k] == 0 or x[i, j, k] == 1):
        raise ValueError("unique values 0, 1 expected")
