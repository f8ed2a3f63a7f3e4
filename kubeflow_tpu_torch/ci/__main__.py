import sys

from kubeflow_tpu_torch.ci.application_util import main

if __name__ == "__main__":
    sys.exit(main())
