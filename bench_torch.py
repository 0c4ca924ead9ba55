#!/usr/bin/env python3
"""Benchmark entry point of the PyTorch port: prints ONE JSON line (see
bin_tpu_torch/benchmark.py).  Runs on the card; ``--device cpu`` times the
plain PyTorch versions on the CPU."""

from bin_tpu_torch.benchmark import main

if __name__ == "__main__":
    main()
