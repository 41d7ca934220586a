"""Decoding helpers of the port: token picking and prefill bucketing."""
