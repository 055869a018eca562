"""``python -m repro_torch.analysis`` — see the package docstring."""

from __future__ import annotations

import sys

from repro_torch.analysis import main

if __name__ == "__main__":
    sys.exit(main())
