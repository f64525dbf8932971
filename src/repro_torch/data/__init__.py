"""Synthetic steelworks workload generator."""
