"""``python -m kungfu_tpu_torch`` runs the launcher (port of
``kungfu_tpu/__main__.py``; :mod:`kungfu_tpu_torch.runner.cli`)."""

import sys

from kungfu_tpu_torch.runner.cli import main

if __name__ == "__main__":
    sys.exit(main())
