"""Synthetic data streams of the port: graphs, recsys batches and serving
query traces."""
from repro_torch.data import graphs, query_trace, sampler, synthetic

__all__ = ["graphs", "query_trace", "sampler", "synthetic"]
