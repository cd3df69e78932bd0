"""Devices for data-parallel inference and DP x TP training, and the
score reduction.

Counterpart of the JAX package's parallel/mesh.py. A "mesh" here is a tuple
of torch.devices: the InferenceEngine keeps one model replica on each and
gives each replica whole batches of batch_size rows (infer/engine.py), where
the JAX engine's 'data'-axis sharding splits each batch's rows; rows are
independent through the network, so the answers are the same. None means
one device.

On the CPU (device="cpu") a mesh of N is N replicas on the CPU, as the JAX
package's tests run a mesh over virtual CPU devices, so the data-parallel
path runs without a GPU.

Training takes a grid instead, make_train_mesh: rows are the 'data' axis,
columns the 'model' axis. replicate_params and shard_params_tp place a
copy of the parameters on every device of it (shard_params_tp splits fc6's
output columns and fc7's input rows over the model axis, as the JAX
package's does), and models/train.make_mesh_train_step runs the step.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def make_mesh(n_devices: Optional[int] = None,
              device: str = "cuda") -> Tuple[torch.device, ...]:
    """The first n_devices local devices of one kind (all visible GPUs
    when n_devices is None); on the CPU, n_devices replicas of it."""
    if device == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    n = torch.cuda.device_count() if n_devices is None else n_devices
    return tuple(torch.device("cuda", i) for i in range(n))


def resolve_mesh(spec: str = "auto", device: str = "cuda"
                 ) -> Optional[Tuple[torch.device, ...]]:
    """CLI --mesh flag -> devices, or None (single-device engine).

    'auto' = every visible GPU when more than one is visible (one device on
    the CPU); 'none', '0' and '1' force the single-device engine; an integer
    N uses the first N GPUs, or N CPU replicas with device='cpu'. Raises
    ValueError when N exceeds the visible GPUs."""
    if spec is None or str(spec).lower() in ("none", "0", "1"):
        return None
    if str(spec) == "auto":
        if device == "cpu":
            return None
        n = torch.cuda.device_count()
    else:
        n = int(spec)
    if n <= 1:
        return None
    if device != "cpu" and n > torch.cuda.device_count():
        raise ValueError(f"--mesh {spec}: only {torch.cuda.device_count()} "
                         "CUDA devices visible")
    return make_mesh(n, device)


def make_train_mesh(data: int, model: int = 1, device: str = "cuda"
                    ) -> Tuple[Tuple[torch.device, ...], ...]:
    """A (data x model) grid of devices for training: the first
    data*model GPUs, row by row; on the CPU, data*model replicas of it.
    Raises ValueError when fewer GPUs are visible."""
    n = data * model
    if device != "cpu" and n > torch.cuda.device_count():
        raise ValueError(f"a {data}x{model} mesh needs {n} GPUs, "
                         f"{torch.cuda.device_count()} visible")
    flat = make_mesh(n, device)
    return tuple(flat[d * model:(d + 1) * model] for d in range(data))


# parameters split over the model axis, and the dim of their torch layout
# that is split: fc6's output columns ([out,in] rows), fc7's input rows
# ([out,in] columns)
_TP_SPLIT = {"fc6.weight": 0, "fc6.bias": 0, "fc7.weight": 1}


def _place(params: Mapping[str, object], mesh, split: bool):
    from svision_tpu_torch.models.alexnet import params_from_numpy
    state = params_from_numpy({k: torch.as_tensor(v, dtype=torch.float32)
                               for k, v in params.items()})
    cells = []
    for row in mesh:
        placed = []
        for m, dev in enumerate(row):
            cell = {}
            for k, t in state.items():
                if split and k in _TP_SPLIT:
                    t = t.chunk(len(row), _TP_SPLIT[k])[m]
                cell[k] = t.to(dev).clone(
                    memory_format=torch.contiguous_format).requires_grad_(True)
            placed.append(cell)
        cells.append(tuple(placed))
    return tuple(cells)


def replicate_params(params: Mapping[str, object], mesh):
    """TF-named params -> cells[d][0], a dict of AlexNet parameter names
    to leaf tensors (f32, requiring grad) on each device of a one-column
    grid (data parallel): a full copy everywhere. A grid with a model axis
    is placed by shard_params_tp."""
    if len(mesh[0]) > 1:
        raise ValueError("replicate_params: the grid has a model axis; "
                         "use shard_params_tp")
    return _place(params, mesh, split=False)


def shard_params_tp(params: Mapping[str, object], mesh):
    """Tensor-parallel placement: fc6 column-split and fc7 row-split over
    the model axis (in the TF layout [in,out]); everything else a full
    copy on every device."""
    return _place(params, mesh, split=True)


def holders(cells) -> List[List[Tuple[Tuple[int, int], str]]]:
    """The copies of each parameter tensor, as ((data row, model column),
    name) in row-major order: for a replicated parameter one per cell, for
    a model-axis shard one per data row of its column."""
    groups: Dict[Tuple[str, Optional[int]], list] = {}
    for d, row in enumerate(cells):
        for m, cell in enumerate(row):
            for k in cell:
                shard = m if k in _TP_SPLIT and len(row) > 1 else None
                groups.setdefault((k, shard), []).append(((d, m), k))
    return list(groups.values())


def gather_params(cells) -> Dict[str, np.ndarray]:
    """cells -> TF-named numpy params, the model-axis shards joined (from
    data row 0)."""
    from svision_tpu_torch.models.alexnet import params_to_numpy
    row = cells[0]
    state = {}
    for k in row[0]:
        if k in _TP_SPLIT and len(row) > 1:
            state[k] = torch.cat([c[k].detach().cpu() for c in row],
                                 _TP_SPLIT[k])
        else:
            state[k] = row[0][k]
    return params_to_numpy(state)


def ShardedInference(params, mesh: Sequence[torch.device],
                     batch_size: int = 128, bf16: bool = True,
                     fast: bool = True, chunk: int = 8):
    """Data-parallel raster+CNN forward over a mesh: the mesh-aware
    InferenceEngine (one model replica a device, each taking whole batches
    of batch_size rows; fast and chunk passed through), so the single- and
    multi-device paths cannot drift."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    return InferenceEngine(params, batch_size=batch_size, bf16=bf16,
                           fast=fast, chunk=chunk, devices=mesh)


def global_score_minmax(local_scores: np.ndarray,
                        mesh: Sequence[torch.device]) -> Tuple[float, float]:
    """Min/max of the QUAL scores, reduced in f32 on the mesh's first
    device (the JAX package's on-device reduction; the pipeline's merge
    scans the score files instead, SVision:330-334). Empty input gives
    (inf, -inf), the identities of min and max."""
    if local_scores.size == 0:
        return float("inf"), float("-inf")
    x = torch.as_tensor(np.asarray(local_scores, np.float32),
                        device=mesh[0])
    lo, hi = torch.stack([x.min(), x.max()]).tolist()
    return float(lo), float(hi)
