from repro_torch.data.pipeline import (DataConfig, DataLoader, MemmapSource,
                                       SyntheticSource, write_token_bin)

__all__ = ["DataConfig", "DataLoader", "MemmapSource", "SyntheticSource",
           "write_token_bin"]
