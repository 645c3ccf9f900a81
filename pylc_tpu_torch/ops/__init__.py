"""Tensor ops of the port: normalize, tiles, dense CRF."""
