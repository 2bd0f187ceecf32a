"""``python -m kungfu_tpu_torch.analysis`` runs kflint over the port's
tree (:mod:`kungfu_tpu_torch.analysis.cli`)."""

import sys

from kungfu_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
