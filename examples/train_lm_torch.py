"""Federated LM training on the PyTorch port, on an assigned architecture.

Counterpart of `examples/train_lm.py`: a shell over
`repro_torch.launch.train.main`, which takes the reference CLI's flags
and ``--device`` (default ``cuda``; it raises without a card unless
``--device cpu`` is given).  The default preset is CPU-sized; ``--preset
lm-100m`` trains a ~100M-parameter model and ``--preset full`` the
assigned config.  Exits 1 when the run returns nothing, as the
reference's script does.

    PYTHONPATH=src python examples/train_lm_torch.py --arch stablelm-3b \\
        --steps 30 [--device cpu]
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
