"""Core configuration (a copy of `mergenet_tpu/core/config.py`; files
written by either package read back in the other): the invariants shared
by data prep, training, and decoding (num_classes / num_colors / offsets
/ padding), persisted as a simple text file.

Behavioral parity: reference `utils/core_config.py` (same file format so
configs written by either implementation interoperate).
"""

from .offsets import validate_offsets


class CoreConfig:
    """Holds and (de)serializes core invariants.

    File format — one key per line:
        num_classes 2
        num_colors 3
        padding 10
        offsets 1 0  0 1  -2 -1
    """

    def __init__(self):
        # number of object classes; class 0 == background.
        self.num_classes = 2
        # channels in input images (1 = grayscale, 3 = RGB).
        self.num_colors = 1
        # log-spiral default (see offsets.generate_offsets).
        self.offsets = [(1, 0), (0, 1), (-2, -1), (1, -2), (3, 2),
                        (-4, 3), (-4, -7), (10, -4), (3, 15), (-21, 0)]
        # zero padding applied around images prior to train/test crops.
        self.padding = 10

    def validate(self, train_image_size=None):
        """Validate config values; raises AssertionError on problems."""
        assert self.num_classes >= 2
        assert 1 <= self.num_colors <= 3
        validate_offsets(self.offsets)
        assert self.padding >= 0
        assert (train_image_size is None) or (
            train_image_size > 0 and train_image_size > 4 * self.padding)

    def write(self, filename):
        try:
            f = open(filename, "w")
        except OSError:
            raise Exception(
                "Failed to open file {0} for writing configuration".format(filename))
        with f:
            for s in ["num_classes", "num_colors", "padding"]:
                print("{0} {1}".format(s, self.__dict__[s]), file=f)
            print("offsets {}".format("  ".join(
                "{0} {1}".format(o[0], o[1]) for o in self.offsets)), file=f)

    def read(self, filename):
        try:
            f = open(filename, "r")
        except OSError:
            raise Exception(
                "Failed to open file {0} for reading configuration".format(filename))
        with f:
            for line in f:
                a = line.split()
                if len(a) == 0 or a[0][0] == "#":
                    continue
                if len(a) == 2 and a[0] in ["num_classes", "num_colors", "padding"]:
                    try:
                        self.__dict__[a[0]] = int(a[1])
                    except ValueError:
                        raise Exception(
                            "Parsing config line in {0}: bad line {1}".format(
                                filename, line))
                elif a[0] == "offsets":
                    if len(a) < 5 or len(a) % 2 == 0:
                        raise Exception(
                            "Parsing offsets config line in {0}: bad num-fields: "
                            "{1}".format(filename, line))
                    try:
                        num_offsets = (len(a) - 1) // 2
                        self.offsets = [
                            (int(a[i * 2 + 1]), int(a[i * 2 + 2]))
                            for i in range(num_offsets)]
                    except ValueError:
                        raise Exception(
                            "Parsing offsets config line in {0}: bad offsets "
                            "line: {1}".format(filename, line))
        self.validate()
