"""The data pipeline of the PyTorch port: stores (``zarrlite``, ``blosc``,
the native host library), the synthetic store and the preprocessor, the
dataset, the loader and the datamodule, and the feature-name bookkeeping.

Only the feature names are imported here; the other modules load on use.
"""

from paradis_torch.data.features import dyn_output_features, num_common_features

__all__ = ["dyn_output_features", "num_common_features"]
