"""In-transit analysis: staged reductions from compute to lightweight HDep.

The paper's in-situ/in-transit layer (fig. 1): instead of dumping full
state for post-hoc processing, the compute flow stages snapshots to an
analysis flow that reduces them to purpose-specific lightweight objects
written at an independent cadence.

  * :mod:`staging`   — double-buffered hand-off with a bounded queue and
    explicit backpressure (``block``/``drop-oldest``/``subsample``).
  * :mod:`partition` — contributor-group split of a staged step.
  * :mod:`reducers`  — composable reduction operators over AMR trees and
    tensor snapshots, combined in a DAG.
  * :mod:`lanes`     — the pluggable lane runtime (``thread`` or
    ``process`` lanes).
  * :mod:`engine`    — per-group lanes writing reduced HDep domains.
  * :mod:`device`    — on-GPU reduction: device-resident staging plus a
    device-reducer registry over the CUDA raster kernels, so only
    *reduced* objects cross the device→host boundary
    (``InTransitEngine(device_reduce=True)``).
  * :mod:`catalog`   — the read side: cached, domain-merged queries.
"""
from .catalog import Catalog                                   # noqa: F401
from .engine import InTransitEngine                            # noqa: F401
from .lanes import (BACKENDS, LANE_POOL, LaneBackend,          # noqa: F401
                    register_backend, shutdown_pool)
from .partition import partition_snapshot                      # noqa: F401
from .reducers import (LevelHistogramReducer, LODCutReducer,   # noqa: F401
                       ProjectionReducer, Reducer, ReducerDAG,
                       SliceReducer, SpectraReducer, TensorNormReducer)
from .staging import (POLICIES, ShmStagingArea, Snapshot,      # noqa: F401
                      StagingArea, StrideController)
from .device import (DeviceDAGRunner, DeviceStagingArea,       # noqa: F401
                     DeviceTree, device_impl_for, register_device_impl,
                     to_device)
