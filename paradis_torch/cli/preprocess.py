"""Preprocessing CLI: ``python -m paradis_torch.cli.preprocess -i RAW -o STORE``.

A thin wrapper over :mod:`paradis_torch.data.preprocess` (the port's copy of
the JAX package's preprocessor).
"""

from paradis_torch.data.preprocess import main

if __name__ == "__main__":
    main()
