"""Console entry point of the PyTorch port.

Usage:
    python -m polymer_chemprop_tpu_torch.cli train --data_path ... \
        --dataset_type regression --save_dir ... [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli predict --test_path ... \
        --checkpoint_dir ... --preds_path ... [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli fingerprint --test_path ... \
        --checkpoint_dir ... --preds_path ... [--fingerprint_type MPN|last_FFN]
    python -m polymer_chemprop_tpu_torch.cli hyperopt --data_path ... \
        --dataset_type ... --num_iters N [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli interpret --data_path ... \
        --checkpoint_dir ... [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli ssl_pretrain --data_path ... \
        --save_dir ... [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli web --port 5000 [--device cuda|cpu]
    python -m polymer_chemprop_tpu_torch.cli sklearn_train --data_path ... \
        --dataset_type ... --save_dir ... [--model_type svm] [--device cpu]
    python -m polymer_chemprop_tpu_torch.cli sklearn_predict --test_path ... \
        --checkpoint_dir ... --preds_path ... [--device cuda|cpu]

Each runs on the GPU (``--device cuda``, the default; without a GPU it
raises) or, when asked, on the CPU with the kernels' plain PyTorch
versions. Checkpoint directories may hold the JAX package's ``.ckpt``
files or reference torch ``.pt`` files. Featurization uses the C++ library
of native_ext.py (built with g++ at first use);
``--no_use_native_featurizer`` takes the Python featurizer instead.
``sklearn_train`` fits the port's random forests and SVMs (baselines/) on
Morgan bits; ``sklearn_predict`` reads the port's ``model.pkl`` and the
JAX package's, without scikit-learn.
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
    elif cmd == "hyperopt":
        from .hyperparameter_optimization import chemprop_hyperopt
        chemprop_hyperopt(rest)
    elif cmd == "interpret":
        from .interpret import chemprop_interpret
        chemprop_interpret(rest)
    elif cmd == "ssl_pretrain":
        from .ssl import ssl_pretrain_cli
        ssl_pretrain_cli(rest)
    elif cmd == "web":
        from .web.app import chemprop_web
        chemprop_web(rest)
    elif cmd == "sklearn_train":
        from .sklearn_train import sklearn_train
        sklearn_train(rest)
    elif cmd == "sklearn_predict":
        from .sklearn_predict import sklearn_predict
        sklearn_predict(rest)
    else:
        print(f"unknown command {cmd!r}\n{__doc__}")
        sys.exit(1)


if __name__ == "__main__":
    main()
