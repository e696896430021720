from .pipeline import SyntheticLMData, batch_rows

__all__ = ["SyntheticLMData", "batch_rows"]
