"""Host-side native code of the port: the record loader.

Built with the host C++ compiler at first use (`native/build.py`);
nothing here needs CUDA."""

from kubeflow_tpu_torch.native.dataloader import RecordLoader, RecordWriter, stat_record_file

__all__ = ["RecordLoader", "RecordWriter", "stat_record_file"]
