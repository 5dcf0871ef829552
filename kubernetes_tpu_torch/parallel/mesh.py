"""The node mesh: the cluster-size axis split into node shards.

Port of `kubernetes_tpu/parallel/mesh.py`. The reference evaluates the
full pods x nodes matrices and shards the node axis over chips: node
columns and the greedy residuals live shard-local, and the only traffic
between shards is a few [K]-wide max/min elections a chunk of pods. The
layout keeps the reference's two axes:

  * "nodes"  the node columns of every mask/score matrix and the per-node
    residual state of the solve; shard s owns rows [s * Nl, (s + 1) * Nl)
    of a node capacity N = S * Nl;
  * "pods"   an optional data-parallel axis over the batch of the mask and
    score compute; the sequential solve gathers it back first, so it
    changes no result.

In the port a mesh is S node shards of ONE device. On the card each shard
is one CTA of a thread-block cluster, and the elections between shards are
reads of each other's shared memory behind a cluster barrier
(`csrc/solver.cu`, `csrc/arbiter.cu`); on the CPU (`device="cpu"`) the plain versions write
the shard axis out. A mesh whose devices are not all one device is the
multi-card transport (torch.distributed / NCCL), which the port does not
have yet: it raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..device import resolve_device

AXIS_NODES = "nodes"
AXIS_PODS = "pods"

# the shard count of node_mesh() when neither a count nor devices are
# given: the portable size of a thread-block cluster
DEFAULT_SHARDS = 8

MULTI_CARD = "the multi-card transport (ROADMAP queue 1 item 11: torch.distributed / NCCL, parallel/multihost.py)"


class Mesh:
    """A ("pods", "nodes") grid over one device: `grid[p][n]` is the device
    of pod slice p and node shard n (`grid[p, n] = devs[n * pods_parallel
    + p]`, the reference's layout). Hashable by its grid and axis names, so
    per-mesh memos key on it."""

    def __init__(self, grid: Tuple[Tuple[torch.device, ...], ...]):
        self.grid = grid
        self.axis_names = (AXIS_PODS, AXIS_NODES)
        self.shape = {AXIS_PODS: len(grid), AXIS_NODES: len(grid[0])}
        self.device = grid[0][0]

    def __hash__(self) -> int:
        return hash((self.grid, self.axis_names))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.grid, self.axis_names) == (other.grid, other.axis_names)

    def __repr__(self) -> str:
        return f"Mesh(pods={self.shape[AXIS_PODS]}, nodes={self.shape[AXIS_NODES]}, device={self.device})"


def indexed_device(d) -> torch.device:
    """`d` as a torch.device, a CUDA one with its index filled in, so that
    "cuda" and "cuda:0" name one card."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def node_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    pods_parallel: int = 1,
    device=None,
) -> Mesh:
    """Build a ("pods", "nodes") mesh of `n_devices` slots (default: the
    length of `devices`, else DEFAULT_SHARDS), all on one device: `device`
    (the card unless "cpu"), or the one device `devices` names.
    `pods_parallel` splits the slots into a data-parallel pod axis; the
    rest shard the node axis. It must divide the slot count."""
    if devices is not None:
        devs = [indexed_device(d) for d in devices]
        if device is not None:
            devs.append(indexed_device(device))
        if len(set(devs)) > 1:
            raise NotImplementedError(f"a mesh over {sorted({str(d) for d in devs})}: {MULTI_CARD}")
        devs = devs[: len(devices)]
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(f"need {n_devices} devices, have {len(devs)}")
            devs = devs[:n_devices]
        if not devs:
            raise ValueError("need at least one device")
        one = indexed_device(resolve_device(devs[0]))
        n = len(devs)
    else:
        n = DEFAULT_SHARDS if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"need at least one device, asked for {n}")
        one = indexed_device(resolve_device(device))
    if n % pods_parallel != 0:
        raise ValueError(f"pods_parallel={pods_parallel} does not divide {n} devices")
    shards = n // pods_parallel
    grid = tuple(tuple(one for _ in range(shards)) for _ in range(pods_parallel))
    return Mesh(grid)


def node_shards(mesh: Mesh) -> int:
    return mesh.shape[AXIS_NODES]


def shard_rows(n: int, shards: int) -> int:
    """Node rows a shard: the capacity must divide evenly (the reference
    asserts it; the driver falls back, counted, where it does not)."""
    if shards < 1 or n % shards:
        raise ValueError(f"node capacity {n} not divisible by {shards} shards")
    return n // shards
