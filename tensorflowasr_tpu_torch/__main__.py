"""``python -m tensorflowasr_tpu_torch`` → the command line (same as the console script)."""

import sys

from tensorflowasr_tpu_torch.scripts import main

if __name__ == "__main__":
    sys.exit(main())
