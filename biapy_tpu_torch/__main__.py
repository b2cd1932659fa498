"""CLI entry point: ``python -m biapy_tpu_torch --config job.yaml ...``."""

from biapy_tpu_torch import main

if __name__ == "__main__":
    main()
