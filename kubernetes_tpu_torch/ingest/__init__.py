"""Pod-ingest plane: pod rows encoded once, at admission, into a slab with a
device-resident twin; a covered dispatch ships only an index vector.

The port of `kubernetes_tpu/ingest`:

* `stage`  — `PodStage`: a host slab of encoded pod-spec rows (the exact
  `state/tensors.PodBatch` layout), content-interned by `spec_key` and
  refcounted by queue entries; the queue stages a pod when it admits it
  and the entry carries a ready (row, generation) pair.
* `bank`   — `StageBank`: the slab's twin on the device, patched by the
  dirty rows at dispatch through csrc/slab.cu's row scatter.
* `gather` — `stage_problem` / `gather_stage`: the batch's pod arrays
  rebuilt on the device from the twin and an int32 index vector,
  csrc/slab.cu's batch gather (one launch with the term table).

Coverage is per batch: every rep must hold a valid staged row whose
generation matches, or re-stage at dispatch (counted); a batch that cannot
(slab at its ceiling, a rebuild mid-resolve) takes the legacy host-built
PodBatch, counted. Placements are bit-identical either way.
"""

from .bank import StageBank
from .gather import gather_stage, gather_stage_plain, stage_problem
from .stage import MAX_CAPACITY, MIN_CAPACITY, PodStage

__all__ = ["PodStage", "StageBank", "gather_stage", "gather_stage_plain", "stage_problem", "MAX_CAPACITY",
           "MIN_CAPACITY"]
