"""Data bookkeeping of the PyTorch port (feature names; the dataset is not ported yet)."""

from paradis_torch.data.features import dyn_output_features, num_common_features

__all__ = ["dyn_output_features", "num_common_features"]
