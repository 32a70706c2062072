"""Synthetic data streams of the port: graphs, recsys batches and serving
query traces."""
