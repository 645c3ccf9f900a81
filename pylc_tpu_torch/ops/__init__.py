"""Tensor ops of the port: normalize, tiles, dense CRF, losses, palette,
profile and augmentation."""
