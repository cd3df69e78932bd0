"""The one traffic generator: a mix file of parameters -> the inputs a
driver feeds the program. numpy only, so it runs anywhere.

Two kinds of mix, by the file's "kind":

  calls   a closed loop of calls, one caller, as cli.run_pipeline calls
          InferenceEngine.predict_specs once a chromosome: "calls" lists
          [name, Mb] in order, "candidates_per_mb" sets each call's size
          round(Mb x density). The sizes are the same for every seed; the
          seed draws the specs.
  table   a labelled table of "rows" specs (label i % "classes") that a
          training loop draws its batches from.

Specs come from the mix's "geometry" generator; `random_specs` is the one
there is, a frozen copy of svision_tpu_torch.timing.random_specs (mixed
scales and strands) that draws from a given RandomState.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np


def rng(seed: int, *keys: str) -> np.random.RandomState:
    """A RandomState for one purpose of a run, from any whole-number seed
    (beyond 32 bits too) and the purpose's name."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *(zlib.crc32(k.encode()) for k in keys)]
    return np.random.RandomState(
        np.random.SeedSequence(words).generate_state(1)[0])


def torch_seed(seed: int, *keys: str) -> int:
    """A 63-bit seed for a torch.Generator, from the same inputs as rng."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *(zlib.crc32(k.encode()) for k in keys)]
    hi, lo = np.random.SeedSequence(words).generate_state(2)
    return ((int(hi) << 32) | int(lo)) >> 1


def random_specs(n: int, rs: np.random.RandomState) -> np.ndarray:
    """Candidate specs [n,12] (xs1, xe1, ys1, ye1, fwd1, xs2, xe2, ys2,
    ye2, fwd2, read_len, ref_len) with mixed scales and strands."""
    specs = np.zeros((n, 12), dtype=np.int64)
    scale = rs.choice([1, 2, 8, 40], size=n)
    read_len = (227 * scale * rs.uniform(0.5, 1.0, n)).astype(np.int64) + 100
    ref_len = (227 * scale * rs.uniform(0.5, 1.0, n)).astype(np.int64) + 100
    for k, base in ((0, read_len), (5, read_len)):
        specs[:, k] = rs.randint(0, 1000, n) % np.maximum(base // 2, 1)
    for k, base in ((2, ref_len), (7, ref_len)):
        lo = rs.randint(0, 1000, n) % np.maximum(base // 2, 1)
        specs[:, k] = lo
        specs[:, k + 1] = lo + np.maximum(
            (base * rs.uniform(0.2, 0.9, n)).astype(np.int64), 2)
    specs[:, 4] = 1
    specs[:, 9] = rs.randint(0, 2, n)
    specs[:, 10] = read_len
    specs[:, 11] = ref_len
    return specs


GEOMETRIES = {"random_specs": random_specs}


def call_sizes(mix: dict) -> List[Tuple[str, int]]:
    """[(name, specs)] of a 'calls' mix, in call order."""
    if mix["kind"] != "calls":
        raise ValueError(f"mix kind {mix['kind']!r} has no calls")
    density = float(mix["candidates_per_mb"])
    return [(name, int(round(mb * density))) for name, mb in mix["calls"]]


def calls(mix: dict, seed: int) -> List[Tuple[str, np.ndarray]]:
    """[(name, specs [n,12])] of a 'calls' mix: one draw of all specs from
    the seed, cut into the calls in order."""
    sizes = call_sizes(mix)
    specs = GEOMETRIES[mix["geometry"]](sum(n for _, n in sizes),
                                        rng(seed, "specs"))
    out, at = [], 0
    for name, n in sizes:
        out.append((name, specs[at:at + n]))
        at += n
    return out


def table(mix: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(specs [rows,12], labels int64 [rows]) of a 'table' mix."""
    if mix["kind"] != "table":
        raise ValueError(f"mix kind {mix['kind']!r} is not a table")
    n = int(mix["rows"])
    specs = GEOMETRIES[mix["geometry"]](n, rng(seed, "specs"))
    return specs, np.arange(n, dtype=np.int64) % int(mix["classes"])
