"""``python -m kubeflow_tpu_torch.launcher``: see `launcher/launcher.py`."""

import logging
import sys

from kubeflow_tpu_torch.launcher.launcher import main

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
