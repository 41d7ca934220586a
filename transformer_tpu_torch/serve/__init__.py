"""Serving of the port: the paged-KV continuous-batching scheduler."""
