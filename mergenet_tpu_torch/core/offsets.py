"""Logarithmic-spiral offset generation (a copy of
`mergenet_tpu/core/offsets.py`; pure Python).

The sameness head predicts, for each pixel p and each offset o=(i,j), the
probability that p and p+o belong to the same instance.  Offsets are drawn
from a log spiral (angle step 100 degrees) so that nearby offsets capture
local connectivity and far offsets see across occlusions.

Behavioral parity: reference `utils/train_utils.py:317-328`
(`generate_offsets`) and `utils/core_config.py:29-44` (documented default).
"""

import math


def generate_offsets(max_offset=20, num_offsets=10):
    """Generate `num_offsets` (x, y) integer offsets along a log spiral.

    The spiral turns by 100 degrees per step; the radius grows geometrically
    such that the last offset's max-|coordinate| reaches `max_offset`.
    """
    offset_list = []
    angle = math.pi * 5 / 9  # 100 degrees: just over 90 degrees.
    triangle = max(abs(math.cos((num_offsets - 1) * angle)),
                   abs(math.sin((num_offsets - 1) * angle)))
    base = abs(max_offset / triangle)
    size_ratio = math.pow(base, 1 / float(num_offsets - 1))
    for n in range(num_offsets):
        x = int(round(math.cos(n * angle) * math.pow(size_ratio, n)))
        y = int(round(math.sin(n * angle) * math.pow(size_ratio, n)))
        offset_list.append((x, y))
    return offset_list


def validate_offsets(offsets):
    """Check an offset list is usable: non-empty, no (0,0), no duplicates,
    and no redundant negated pairs.  (reference `core_config.py:66-73`)"""
    assert len(offsets) > 0 and (0, 0) not in offsets
    offsets_set = set(offsets)
    assert len(offsets_set) == len(offsets), "duplicate offsets"
    for o in offsets:
        assert isinstance(o, tuple) and len(o) == 2
        assert (-o[0], -o[1]) not in offsets_set, \
            "negated offset pair {} is redundant".format(o)
    return True
