"""biapy_tpu_torch: the PyTorch / CUDA port of biapy_tpu, for NVIDIA Hopper.

The JAX package ``biapy_tpu`` stays the reference; this package imports
nothing of it. Entry points run on the CUDA card unless the caller asks for
the CPU (``BiaPy(..., device="cpu")``).

CLI: ``python -m biapy_tpu_torch --config job.yaml --result_dir RD --name J``
with the flags of the JAX package's CLI; ``--gpu`` picks the card index.
"""

__version__ = "0.1.0"

import argparse
import os


def main():
    parser = argparse.ArgumentParser(description="biapy_tpu_torch job runner")
    parser.add_argument("--config", required=True, help="Path to the YAML configuration file")
    parser.add_argument("--result_dir", default=os.getenv("HOME", "."),
                        help="Where results are stored")
    parser.add_argument("--name", default="unknown_job", help="Job name")
    parser.add_argument("--run_id", type=int, default=1, help="Run number for the same job")
    parser.add_argument("--gpu", default=None, help="CUDA card index (default 0)")
    parser.add_argument("-v", "--version", action="version",
                        version="biapy_tpu_torch version " + __version__)
    parser.add_argument("--world_size", type=int, default=1,
                        help="Ignored (one card; distributed runs are not ported yet)")
    parser.add_argument("--local_rank", type=int, default=-1, help="Ignored")
    parser.add_argument("--dist_on_itp", action="store_true", help="Ignored")
    parser.add_argument("--dist_url", default="env://", help="Ignored")
    parser.add_argument("--dist_backend", default="nccl",
                        choices=["ici", "dcn", "nccl", "gloo"], help="Ignored")
    args = parser.parse_args()

    from biapy_tpu_torch._biapy import BiaPy

    job = BiaPy(args.config, result_dir=args.result_dir, name=args.name,
                run_id=args.run_id, gpu=args.gpu)
    job.run_job()


def __getattr__(name):
    if name == "BiaPy":
        from biapy_tpu_torch import _biapy

        return _biapy.BiaPy
    raise AttributeError(name)
