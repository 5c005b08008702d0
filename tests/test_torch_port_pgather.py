"""The shared-memory table lookup of the port (`ops/pgather.py`, the
counterpart of `scripts/bench_pallas_gather.py::pallas_gather`) on the
CPU, where the wrapper takes its plain version: against the script's own
reference `np.asarray(table)[np.asarray(idx)]` on the script's data
(RandomState(0), M = 8192 and 65536) at N = 262144, bit-equal.  The
Pallas prototype itself is a TPU kernel without an interpret switch, so
the script's reference stands for it.  The kernel is held against this
plain version on the card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from mergenet_tpu_torch import bench_pallas_gather as bench
from mergenet_tpu_torch.ops import _build
from mergenet_tpu_torch.ops.pgather import pgather, pgather_plain


def test_pgather_matches_the_scripts_reference():
    rng = np.random.RandomState(0)
    for M in bench.SIZES:
        table, idx = bench.make_inputs(M, rng, n=262144)
        assert table.dtype == idx.dtype == np.int32
        assert 0 <= idx.min() and idx.max() < M
        ref = np.asarray(table)[np.asarray(idx)]
        before = dict(_build.LAUNCHES)
        got = pgather(torch.from_numpy(table), torch.from_numpy(idx))
        assert dict(_build.LAUNCHES) == before  # CPU: no kernel launched
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_pgather_plain_clamps_out_of_range_indices():
    table = torch.arange(10, 20, dtype=torch.int32)
    idx = torch.tensor([-2 ** 31, -1, 0, 9, 10, 2 ** 31 - 1],
                       dtype=torch.int32)
    assert pgather_plain(table, idx).tolist() == [10, 10, 10, 19, 19, 19]
    assert pgather(table, idx).tolist() == [10, 10, 10, 19, 19, 19]


@pytest.mark.parametrize("table,idx", [
    (torch.zeros(8, dtype=torch.int64), torch.zeros(4, dtype=torch.int32)),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(4, dtype=torch.int64)),
    (torch.zeros(0, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)),
    (torch.zeros(8, dtype=torch.int32),
     torch.zeros((4, 2), dtype=torch.int32)),
    (torch.zeros(8, dtype=torch.int32),
     torch.zeros(8, dtype=torch.int32)[::2]),
])
def test_pgather_rejects_what_the_kernel_does_not_take(table, idx):
    with pytest.raises(ValueError):
        pgather(table, idx)


def test_bench_runs_on_the_card_only():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run()
    with pytest.raises(RuntimeError, match="times the GPU"):
        bench.run("cpu")
