"""Host-side native code of the port: the record loader, and the
compiled control-plane tier (the work queue, the object store and its
write-ahead log in `native/core.py`, the gang scheduler in
`native/scheduler.py`, the store's API server in `native/apiserver.py`).

Built with the host C++ compiler at first use (`native/build.py`);
nothing here needs CUDA."""

from kubeflow_tpu_torch.native.dataloader import RecordLoader, RecordWriter, stat_record_file
from kubeflow_tpu_torch.native.scheduler import (
    GangScheduler,
    PlacementError,
    PyGangScheduler,
    make_gang_scheduler,
)

__all__ = ["GangScheduler", "PlacementError", "PyGangScheduler", "RecordLoader",
           "RecordWriter", "make_gang_scheduler", "stat_record_file"]
