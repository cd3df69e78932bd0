"""Inference devices for data-parallel inference, and the score reduction.

Counterpart of the JAX package's parallel/mesh.py. A "mesh" here is a tuple
of torch.devices: the InferenceEngine keeps one model replica on each and
splits every batch's rows evenly across them (infer/engine.py), which is
what the JAX engine's 'data'-axis sharding does. None means one device.

On the CPU (device="cpu") a mesh of N is N replicas on the CPU, as the JAX
package's tests run a mesh over virtual CPU devices, so the split path runs
without a GPU. The training-only placements (replicate_params,
shard_params_tp) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def ShardedInference(params, mesh: Sequence[torch.device],
                     batch_size: int = 128, bf16: bool = True):
    """Data-parallel raster+CNN forward over a mesh: the mesh-aware
    InferenceEngine (batch rows split over the devices, one model replica
    each), so the single- and multi-device paths cannot drift."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    return InferenceEngine(params, batch_size=batch_size, bf16=bf16,
                           devices=mesh)


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
