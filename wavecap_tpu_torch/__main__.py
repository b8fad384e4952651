"""``python -m wavecap_tpu_torch <command>``: the CLI (``cli.py``).

The port's copy of ``wavecap_tpu/__main__.py``; it runs the CLI only as a
script, so the module imports without running it.
"""

from wavecap_tpu_torch.cli import main
import sys

if __name__ == "__main__":
    sys.exit(main())
