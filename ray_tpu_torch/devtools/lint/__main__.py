# Copied from ray_tpu/devtools/lint/__main__.py; the guard keeps an import
# of this module (a package walk) from running the linter.
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
