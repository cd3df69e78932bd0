"""The dispatch's endpoints made from raw specs (ops/endpoints.py) against
the host's numpy, bit for bit.

specs_endpoints_plain, the plain version of the kernel the engine runs at
the head of each replica's step, must give the JAX package's and the
port's rasterize.specs_to_endpoints exactly, in all three outputs and in
the endpoints of invisible segments too, on the genome mix's specs, the
engine's sentinel and hand-made lines that exercise each branch of the
clip. The CUDA kernel is held to the plain version on the card
(tests/test_torch_kernels_gpu.py).
"""
import numpy as np
import pytest
import torch

from benchmark.traffic import random_specs
from svision_tpu.ops import rasterize as jr
from svision_tpu_torch.infer.engine import InferenceEngine
from svision_tpu_torch.ops import endpoints
from svision_tpu_torch.ops import rasterize as tr

torch.set_num_threads(2)

INSIDE = [10, 0, 10, 20, 1]          # a second segment inside the canvas
WIDE = 22700                         # read and ref length: ratio 100
# name -> (rows: segment 1, segment 2, read_len, ref_len; visible flags)
LINES = {
    # segment: xs, xe, ys, ye, fwd (x = read axis = image row,
    # y = ref axis = image column)
    "leaves_left": ([[10, 0, -50, 100, 1] + INSIDE + [227, 227]],
                    [[True, True]]),
    "leaves_right": ([[0, 0, 150, 350, 1] + INSIDE + [227, 227]],
                     [[True, True]]),
    "leaves_top": ([[-40, 0, 10, 110, 1] + INSIDE + [227, 227]],
                   [[True, True]]),
    "leaves_bottom": ([[150, 0, 0, 200, 1] + INSIDE + [227, 227]],
                      [[True, True]]),
    "both_ends_outside": ([[-100, 0, -100, 400, 1] + INSIDE + [227, 227]],
                          [[True, True]]),
    # x + y = -100 in the canvas's coordinates; then beyond its far corner
    "wholly_outside": ([[100, 0, -200, 100, 0] + INSIDE + [227, 227],
                        [300, 0, 300, 400, 1, 300, 0, 300, 400, 0, 227,
                         227]],
                       [[False, True], [False, False]]),
    # ratio 100: column 0, rows 226 -> 227
    "vertical_across_bottom": ([[22650, 0, -50, 10, 1] + INSIDE
                                + [WIDE, WIDE]], [[True, True]]),
    # ratio 100: row 1, columns 226 -> 227
    "horizontal_across_right": ([[100, 0, 22650, 22710, 1] + INSIDE
                                 + [WIDE, WIDE]], [[True, True]]),
    "ratio_clamped_to_1": ([[10, 0, 20, 120, 1, 200, 0, 90, 140, 0, 100,
                             150]], [[True, True]]),
    "zero_length": ([[5, 0, 5, 5, 1, 5, 0, 5, 5, 0, 227, 227]],
                    [[True, True]]),
    "one_pixel": ([[5, 0, 5, 6, 1, 226, 0, 226, 227, 0, 227, 227]],
                  [[True, True]]),
    "reverse_strands": ([[30, 0, 10, 90, 0, 200, 0, 100, 300, 0, 227,
                          227]], [[True, True]]),
    # any nonzero strand field is forward
    "strand_field_2": ([[30, 0, 10, 90, 2] + INSIDE + [227, 227]],
                       [[True, True]]),
}


def _genome(seed):
    return random_specs(4096, np.random.RandomState(seed))


def _float(seed):
    """The genome mix with fractions and a few negative coordinates: the
    host and the plain version truncate them toward zero alike."""
    rs = np.random.RandomState(seed)
    specs = random_specs(512, rs).astype(np.float64)
    specs[:, :10] += rs.uniform(-0.99, 0.99, (512, 10))
    specs[:64, [0, 2, 5, 7]] -= 3.5
    return specs


CASES = {
    **{f"genome_{s}": (lambda s=s: _genome(s), None)
       for s in (0, 7, 2147483647)},
    "sentinel": (lambda: InferenceEngine._SENTINEL, [[True, True]]),
    **{k: (lambda rows=rows: np.array(rows, dtype=np.int64), vis)
       for k, (rows, vis) in LINES.items()},
    "float_specs": (lambda: _float(5), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_endpoints_equal_the_host(case):
    """specs_endpoints_plain (and the wrapper, which takes it for a CPU
    tensor without counting a launch) equals the JAX package's and the
    port's specs_to_endpoints bit for bit: endpoints int32 [N,2,4] of every
    segment, invisible ones included, visible and reverse bool [N,2]. The
    hand-made lines see the visibility they were made for."""
    make, want_vis = CASES[case]
    specs = make()
    jax_out = jr.specs_to_endpoints(specs)
    port_out = tr.specs_to_endpoints(specs)
    launches = endpoints.specs_endpoints.launches
    for got in (endpoints.specs_endpoints_plain(torch.from_numpy(specs)),
                endpoints.specs_endpoints(torch.from_numpy(specs))):
        for g, j, p, dtype in zip(got, jax_out, port_out,
                                  (torch.int32, torch.bool, torch.bool)):
            assert g.dtype == dtype and g.shape == j.shape == p.shape
            assert np.array_equal(g.numpy(), j) and np.array_equal(
                g.numpy(), p)
    assert endpoints.specs_endpoints.launches == launches
    if want_vis is not None:
        assert port_out[1].tolist() == want_vis
