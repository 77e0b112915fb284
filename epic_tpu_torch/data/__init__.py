"""Data pipeline: image-folder training set + Kodak-style test set."""

from .datasets import ImageFolder, TestImageDataset, data_loader

__all__ = ["ImageFolder", "TestImageDataset", "data_loader"]
