"""Console entry point of the PyTorch port.

Usage:
    python -m polymer_chemprop_tpu_torch.cli train --data_path ... \
        --dataset_type regression --save_dir ... [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli predict --test_path ... \
        --checkpoint_dir ... --preds_path ... [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli fingerprint --test_path ... \
        --checkpoint_dir ... --preds_path ... [--fingerprint_type MPN|last_FFN]

All three run on the GPU (``--device cuda``, the default; without a GPU
they raise) or, when asked, on the CPU with the kernels' plain PyTorch
versions. Each featurizes with the C++ library of native_ext.py (built
with g++ at first use); ``--no_use_native_featurizer`` takes the Python
featurizer instead.
The other subcommands of polymer_chemprop_tpu.cli are not on the port yet.
"""

from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        sys.exit(1)
    cmd, rest = argv[0], argv[1:]
    if cmd == "train":
        from .train.cross_validate import chemprop_train
        chemprop_train(rest)
    elif cmd == "predict":
        from .train.make_predictions import chemprop_predict
        chemprop_predict(rest)
    elif cmd == "fingerprint":
        from .train.molecule_fingerprint import chemprop_fingerprint
        chemprop_fingerprint(rest)
    else:
        print(f"unknown command {cmd!r}\n{__doc__}")
        sys.exit(1)


if __name__ == "__main__":
    main()
