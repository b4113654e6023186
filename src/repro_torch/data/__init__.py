"""Synthetic datasets and federated sharding."""
