"""Entry point: ``python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``harness.py``)."""

import sys

from benchmark.harness import main

if __name__ == "__main__":
    sys.exit(main())
