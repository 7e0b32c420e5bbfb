"""Training data: ``SyntheticLM`` and ``ShardedTokenFiles``
(``pipeline.py``)."""
from .pipeline import ShardedTokenFiles, SyntheticLM, make_batch_iterator

__all__ = ["ShardedTokenFiles", "SyntheticLM", "make_batch_iterator"]
