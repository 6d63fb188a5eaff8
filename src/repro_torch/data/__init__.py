"""Training data of the port: the reference's deterministic synthetic token
corpus (``tokens.py``)."""
from repro_torch.data.tokens import DataConfig, SyntheticCorpus

__all__ = ["DataConfig", "SyntheticCorpus"]
