"""PyTorch model zoo of the port (DeepLabV3+ with ResNet101)."""
